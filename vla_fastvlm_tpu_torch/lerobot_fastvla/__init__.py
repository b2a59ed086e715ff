"""LeRobot plugin of the port: ``policy.type=fastvla`` (counterpart of
``vla_fastvlm_tpu/lerobot_fastvla``).

Importing this package registers the policy type, discoverable with
``--policy.discover_packages_path=vla_fastvlm_tpu_torch.lerobot_fastvla``.
The policy is a plain ``torch.nn.Module`` over the port's
``FastVLMWithExpert``: LeRobot's optimizer updates the head's parameters
directly, with no bridge between frameworks.

The registration needs the ``lerobot`` package (the plugin host). Where it
is absent the package still imports, and reaching for the plugin's names
raises a pointed ImportError.
"""

try:
    import lerobot  # noqa: F401

    _HAS_LEROBOT = True
except ImportError:
    _HAS_LEROBOT = False

if _HAS_LEROBOT:
    from .configuration_fastvla import FastVLAConfig
    from .modeling_fastvla import FastVLAPolicy
    from .processor_fastvla import make_fastvla_pre_post_processors
else:

    def __getattr__(name):
        if name in ("FastVLAConfig", "FastVLAPolicy", "make_fastvla_pre_post_processors"):
            raise ImportError(
                "vla_fastvlm_tpu_torch.lerobot_fastvla requires the `lerobot` "
                "package (the plugin host). For LeRobot-free use, import the "
                "core policy from vla_fastvlm_tpu_torch.fastvla instead."
            )
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["FastVLAConfig", "FastVLAPolicy", "make_fastvla_pre_post_processors"]
