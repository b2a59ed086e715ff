"""VLM text generation CLI of the port (twin of the repository's
``scripts/generate.py``): image + prompt -> caption or answer.

    python -m vla_fastvlm_tpu_torch.scripts.generate --model-id fastvlm-0.5b --prompt "Describe the image."
    python -m vla_fastvlm_tpu_torch.scripts.generate --device cpu --model-id fastvlm-tiny --dtype float32

One prompt and an optional image (``--image PATH``, read through PIL; none
is a zero frame) go through ``serving/generate.py``: one prefill into a dense
KV cache, then one decode step per new token. The decoded text is printed
and returned from ``main``. A preset's weights are random from ``seed``;
a ``--model-id`` naming a local HF FastVLM directory loads its
``*.safetensors`` (``io/model_loader.py``). ``--device`` is the card unless ``--device cpu`` is given;
without CUDA the script raises. ``--quantization int8|int4|w8a8`` quantizes
the decoder's projections (``io/quantize.py``). ``--dp`` / ``--tp`` above 1
generate on a ("data", "model") mesh through ``serving/sharded.py::
sharded_generate``: under ``torchrun`` on its ranks, else on ``dp * tp``
ranks the command starts itself; the prompt is repeated to ``dp`` rows
(the JAX script's batch of one does not split over ``data``) and rank 0
prints row 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..io.presets import resolve_fastvlm_config
from ..model import FastVLMBackbone, FastVLMBackboneConfig
from ..ops.image import prepare_image_batch
from ..parallel import cli_mesh, is_main_rank, needs_own_ranks, spawn_ranks
from ..parallel.sharding import tp_text_config
from ..serving import generate
from ..serving.sharded import sharded_generate
from ..utils import configure_logging, parse_cli


@dataclass
class GenerateArgs:
    model_id: str = "apple/FastVLM-0.5B"
    bootstrap_model_id: str = "apple/FastVLM-0.5B"
    prompt: str = "Describe the image."
    image: Optional[str] = None  # path; None -> zeros
    image_size: Optional[int] = None
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_p: float = 1.0
    tokenizer_max_length: int = 64
    dtype: str = "bfloat16"
    # The card unless "cpu" is asked for.
    device: Optional[str] = "cuda"
    seed: int = 0
    # Mesh factors for sharded generation (dp * tp ranks; 1 x 1 = one card).
    dp: int = 1
    tp: int = 1
    # "int8" | "int4" | "w8a8": quantized decoder projections (io/quantize.py).
    quantization: str = "none"


def main(args: GenerateArgs) -> str:
    if needs_own_ranks(args.dp * args.tp):
        tp_text_config(resolve_fastvlm_config(args.model_id, args.bootstrap_model_id)[0].text, args.tp)
        return spawn_ranks(main, args.dp * args.tp, args, device=args.device)
    mesh, device = cli_mesh(args.dp, args.tp, args.device)
    configure_logging()
    backbone = FastVLMBackbone(FastVLMBackboneConfig(
        model_id=args.model_id, bootstrap_model_id=args.bootstrap_model_id, force_image_size=args.image_size,
        tokenizer_max_length=args.tokenizer_max_length, dtype=args.dtype, param_dtype=args.dtype,
        quantization=args.quantization, seed=args.seed,
    ), device=device)
    mcfg = backbone.model_config
    size = mcfg.image_size
    if args.image:
        from PIL import Image

        raw = np.asarray(Image.open(args.image).convert("RGB"), np.float32) / 255.0
        img = np.transpose(raw, (2, 0, 1))[None]
    else:
        img = np.zeros((1, 3, size, size), np.float32)
    images = None
    if mcfg.num_image_tokens > 0:
        images = prepare_image_batch(backbone.to_device(img), size=size, dtype=mcfg.text.dtype)

    ids, mask = backbone._prep_text([args.prompt])
    gen_kwargs = dict(max_new_tokens=args.max_new_tokens, eos_token_id=getattr(backbone.tokenizer, "eos_token_id", 2)
                      or 2, temperature=args.temperature, top_p=args.top_p)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    ids, mask = np.asarray(ids, np.int32), np.asarray(mask, np.int32)
    if mesh is None:
        tokens = generate(backbone.model, images, ids, mask, generator=generator, **gen_kwargs)
    else:  # the prompt repeated to one row a data rank
        images = None if images is None else images.repeat_interleave(args.dp, 0)
        ids, mask = np.repeat(ids, args.dp, 0), np.repeat(mask, args.dp, 0)
        tokens = sharded_generate(backbone.model, None, images, ids, mask, mesh, rng=generator, **gen_kwargs)
    text = backbone.tokenizer.decode(tokens[0].cpu().numpy().tolist())
    if is_main_rank():
        print(text)
    return text


if __name__ == "__main__":
    main(parse_cli(GenerateArgs, prog="python -m vla_fastvlm_tpu_torch.scripts.generate"))
