"""Paged-KV attention: CUDA kernel wrappers and their plain versions.

Counterpart of ``vla_fastvlm_tpu/ops/pallas/paged_attention.py``: at W = 1
``paged_attention_decode`` -> ``paged_attention_window`` ->
``_paged_attn_kernel`` / ``_paged_attn_kernel_int8`` -> ``_attend_last_page``,
and at W > 1 the same ``paged_attention_window`` over a speculative verify
window. Two hand-written kernels for sm_90a, each with a header that says
what bounds it and how the design answers that: ``csrc/paged_attention.cu``
(W = 1) and ``csrc/paged_window.cu`` (W > 1).

- ``paged_attention_decode(q, pool_k, pool_v, tables, kv_mask, lengths,
  k_new, v_new, pool_k_scale=, pool_v_scale=, scale=)``: one query token per
  slot, ``q`` (B, N, D) against pools (P_total, K, page, D) read through
  ``tables`` (B, P_slot), plus the current token's ``k_new``/``v_new``
  (B, K, D) as one extra column -> (B, N, D). int8 pools come with their
  (P_total, K, page) float32 scale pools.
- ``paged_attention_window(q, ...)``: the verify window, ``q`` (B, W, N, D)
  and ``k_new``/``v_new`` (B, W, K, D) with 2 <= W <= 9; window position i
  attends the stored positions plus window positions <= i -> (B, W, N, D).
- On a CUDA tensor each launches its kernel (bf16 or fp32 queries, pools of
  the query dtype or int8, head_dim 64 or 128, N / K <= 8, page a power of
  two up to 64) or raises; on a CPU tensor each runs its plain version, the
  W-token gather path ``ops.attention.paged_attention_gathered``.
- Both kernels split each slot's stored window across blocks and merge the
  parts inside the same launch (``csrc/paged_split.cuh``): one launch a call,
  int8 scales read through the page table, no host sync. ``split_plan`` fixes
  the number of parts from the shapes and the blocks the kernel instance
  runs at once on the card (``instance_wave``, read once);
  ``paged_attention_split_reference`` is the plain twin of that
  split-and-merge arithmetic, for tests and checks.
- ``lengths`` (B,) is each slot's write cursor. The kernels do not read it:
  like the Pallas kernel they rely on the server's invariant that
  ``kv_mask`` marks only positions below the cursor. The plain version
  inserts the new rows there.
- ``.launches`` on each wrapper counts its kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..attention import paged_attention_gathered
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_REP = 8  # query heads per KV head the kernels are instantiated for
MAX_PAGE = 64
MAX_WINDOW = 9  # verify window positions (k <= 8 draft tokens)
TILE = 64  # stored positions a kernel tile (csrc/paged_split.cuh TP)
MAX_SPLITS = 32  # stored-window parts a (slot, KV head) (csrc/paged_split.cuh)
MASKED = -1e30


def split_plan(b: int, kh: int, p_slot: int, page: int, w: int = 1, *, wave: int) -> int:
    """Parts of the stored window each (slot, KV head) is split into, from the
    shapes and ``wave``, the blocks of the kernel instance the card runs at
    once (``instance_wave``); never the mask, so a CUDA graph can replay the
    launch. The most splits of whole 64-position tiles whose split blocks,
    ``b * kh * splits``, still run in one wave (a second wave waits for the
    first); the new columns' blocks, one more per (slot, KV head), are not
    counted: they attend a single 16-column tile and leave their SM long
    before the split blocks do. At least 1, at most ``MAX_SPLITS``."""
    tiles = -(-p_slot * page // TILE)
    best = 1
    for per in range(tiles, 0, -1):
        splits = -(-tiles // per)
        if splits > MAX_SPLITS or b * kh * splits > wave:
            break
        best = splits
    return best


@functools.lru_cache(maxsize=None)
def _instance_wave(device_index: int, window: bool, w: int, n: int, kh: int, d: int, dtype_code: int,
                   int8: bool) -> int:
    lib = "paged_window" if window else "paged_attention"
    shape = (w, n, kh, d) if window else (n, kh, d)
    fn = _build.LIBRARIES.entry(lib, f"{lib}_blocks_per_sm", [ctypes.c_int] * (len(shape) + 3)
                                + [ctypes.POINTER(ctypes.c_int)], ctypes.c_int)
    blocks = ctypes.c_int(0)
    _build.check(fn(*shape, dtype_code, int(int8), device_index, ctypes.byref(blocks)), f"{lib}_blocks_per_sm")
    return torch.cuda.get_device_properties(device_index).multi_processor_count * blocks.value


def instance_wave(q: torch.Tensor, pool_k: torch.Tensor) -> int:
    """Blocks of the kernel instance that ``q`` (on a CUDA device) and
    ``pool_k`` launch which the card runs at once: its SMs times the blocks
    an SM holds, as the CUDA occupancy calculator reports them from the
    instance's registers and its walk's shared memory (the merge's stage is
    sized to keep that occupancy). Read once per instance and device."""
    window = q.ndim == 4
    return _instance_wave(q.device.index, window, q.shape[1] if window else 1, q.shape[-2], pool_k.shape[1],
                          q.shape[-1], _DTYPES[q.dtype], pool_k.dtype == torch.int8)


def planned_splits(q: torch.Tensor, pool_k: torch.Tensor, tables: torch.Tensor) -> int:
    """The parts a launch on these CUDA tensors splits the stored window into."""
    w = q.shape[1] if q.ndim == 4 else 1
    return split_plan(q.shape[0], pool_k.shape[1], tables.shape[1], pool_k.shape[2], w,
                      wave=instance_wave(q, pool_k))


def split_ranges(s_max: int, splits: int) -> list:
    """The stored positions [s0, s1) of each split: ceil(tiles / splits)
    whole tiles a split from position 0, as the kernels cut them (a forced
    count above the tiles leaves the last splits empty)."""
    tiles = -(-s_max // TILE)
    per = -(-tiles // splits)
    return [(min(s_max, z * per * TILE), min(s_max, (z + 1) * per * TILE)) for z in range(splits)]


def paged_attention_decode_reference(
    q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new,
    pool_k_scale=None, pool_v_scale=None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather the window, insert the new row at the cursor, dense attention."""
    return paged_attention_gathered(
        q[:, None], pool_k, pool_v, tables, kv_mask, lengths, k_new[:, None], v_new[:, None],
        pool_k_scale, pool_v_scale, scale,
    )[:, 0]


# The window kernel's plain version: the W-token gather path itself.
paged_attention_window_reference = paged_attention_gathered


def paged_attention_split_reference(
    q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new,
    pool_k_scale=None, pool_v_scale=None, scale: Optional[float] = None, *, splits: int,
) -> torch.Tensor:
    """The kernels' split-and-merge arithmetic in plain torch (q (B, N, D) or
    (B, W, N, D)), for tests and on-card checks; the main path never runs it.

    Each split of ``split_ranges`` walks its 64-position tiles with an online
    softmax, skips a tile with no valid position, and rounds its
    probabilities (times the V scales of int8 pools) to the value dtype
    relative to its own running maximum; a split with no valid position is
    the neutral part (-inf, 0, 0). The new column(s) form one more part: at
    W = 1 (m, l, o) = (q.k_new * scale, 1, v_new) with its share in fp32; at
    W > 1 the slot-causal window columns, rounded like the stored ones. The
    parts merge in order under their common maximum. ``lengths`` is not
    read, as in the kernels."""
    del lengths
    window = q.ndim == 4
    qw, kn, vn = (q, k_new, v_new) if window else (q[:, None], k_new[:, None], v_new[:, None])
    b, w, n, d = qw.shape
    _, kh, page, _ = pool_k.shape
    rep, p_slot = n // kh, tables.shape[1]
    rows, s_max = w * rep, p_slot * page
    if scale is None:
        scale = d ** -0.5
    quantized = pool_k.dtype == torch.int8
    tl = tables.long()

    def window_of(pool):  # (P, K, page, D) -> (B, K, S, D) float
        return pool[tl].permute(0, 2, 1, 3, 4).reshape(b, kh, s_max, d).float()

    k_win, v_win = window_of(pool_k), window_of(pool_v)
    qg = qw.float().reshape(b, w, kh, rep, d).permute(0, 2, 1, 3, 4).reshape(b, kh, rows, d)
    logits = torch.einsum("bkrd,bksd->bkrs", qg, k_win) * scale
    if quantized:
        k_sc, v_sc = scale_window(pool_k_scale, tables), scale_window(pool_v_scale, tables)
        logits = logits * k_sc[:, :, None, :]
    valid = kv_mask.bool()
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, MASKED))
    round_p = lambda p: p.to(q.dtype).float()

    parts = []
    for s0, s1 in split_ranges(s_max, splits):
        m = torch.full((b, kh, rows), -float("inf"), device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros(b, kh, rows, d, device=q.device)
        for t0 in range(s0, s1, TILE):
            t1 = min(t0 + TILE, s_max)
            hit = valid[:, t0:t1].any(-1)[:, None, None]
            x = logits[..., t0:t1]
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            pv = p * v_sc[:, :, None, t0:t1] if quantized else p
            o_new = o * alpha[..., None] + round_p(pv) @ v_win[:, :, t0:t1]
            l_new = l * alpha + p.sum(-1)
            m, l, o = torch.where(hit, m_new, m), torch.where(hit, l_new, l), torch.where(hit[..., None], o_new, o)
        parts.append((m, l, o))

    kw, vw = (x.float().permute(0, 2, 1, 3) for x in (kn, vn))  # (B, K, W, D)
    l_win = torch.einsum("bkrd,bkwd->bkrw", qg, kw) * scale
    if w == 1:
        parts.append((l_win[..., 0], torch.ones_like(l_win[..., 0]), vw.expand(b, kh, rows, d)))
    else:
        causal = torch.arange(w, device=q.device)[None, :] <= (torch.arange(rows, device=q.device) // rep)[:, None]
        l_win = torch.where(causal, l_win, torch.full_like(l_win, MASKED))
        m_w = l_win.amax(-1)
        p = torch.exp(l_win - m_w[..., None])
        parts.append((m_w, p.sum(-1), round_p(p) @ vw))

    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    total_l, total_o = torch.zeros_like(m_all), torch.zeros(b, kh, rows, d, device=q.device)
    for m, l, o in parts:
        wt = torch.exp(m - m_all)
        total_l = total_l + wt * l
        total_o = total_o + wt[..., None] * o
    out = total_o * (1.0 / total_l)[..., None]
    out = out.reshape(b, kh, w, rep, d).permute(0, 2, 1, 3, 4).reshape(b, w, n, d).to(q.dtype)
    return out if window else out[:, 0]


def check_kernel_shapes(q, pool_k, pool_v, tables, kv_mask, k_new, v_new, pool_k_scale, pool_v_scale) -> None:
    """Raise unless a kernel takes these dtypes, shapes and layouts: the
    decode kernel's q (B, N, D) with k_new / v_new (B, K, D), or the window
    kernel's q (B, W, N, D) with k_new / v_new (B, W, K, D), 2 <= W <= 9."""
    if q.ndim not in (3, 4) or pool_k.ndim != 4:
        raise ValueError(f"paged kernels take q (B, N, D) or (B, W, N, D) and pools (P, K, page, D); got "
                         f"q{tuple(q.shape)} pool{tuple(pool_k.shape)}")
    window = q.shape[1:-2] if q.ndim == 4 else ()
    if window and not 2 <= window[0] <= MAX_WINDOW:
        raise ValueError(f"paged window kernel takes 2 <= W <= {MAX_WINDOW} window positions, got W={window[0]}")
    b, n, d = q.shape[0], q.shape[-2], q.shape[-1]
    _, kh, page, _ = pool_k.shape
    if q.dtype not in _DTYPES or k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError(f"paged kernel takes bf16 or fp32 q/k_new/v_new of one dtype, got "
                         f"{q.dtype}/{k_new.dtype}/{v_new.dtype}")
    quantized = pool_k.dtype == torch.int8
    if pool_v.dtype != pool_k.dtype or pool_k.dtype not in (q.dtype, torch.int8):
        raise ValueError(f"paged kernel takes pools of the query dtype or int8, got {pool_k.dtype}/{pool_v.dtype}")
    if quantized != (pool_k_scale is not None) or quantized != (pool_v_scale is not None):
        raise ValueError("int8 pools need both scale pools, and only int8 pools take them")
    if d not in (64, 128):
        raise ValueError(f"paged kernel takes head_dim 64 or 128, got {d}")
    if q.numel() >= 2 ** 31:
        raise ValueError(f"paged kernel indexes its output with 32-bit offsets; q has {q.numel()} elements")
    if n % kh or n // kh > MAX_REP:
        raise ValueError(f"paged kernel takes N a multiple of K with N / K <= {MAX_REP}, got N={n} K={kh}")
    if page > MAX_PAGE or page & (page - 1):
        raise ValueError(f"paged kernel takes a page size that is a power of two up to {MAX_PAGE}, got {page}")
    if tuple(pool_v.shape) != tuple(pool_k.shape) or tuple(pool_k.shape[3:]) != (d,):
        raise ValueError(f"pool shapes {tuple(pool_k.shape)}/{tuple(pool_v.shape)} for head_dim {d}")
    if tables.ndim != 2 or tables.shape[0] != b:
        raise ValueError(f"tables must be (B, P_slot) with B={b}, got {tuple(tables.shape)}")
    if tuple(kv_mask.shape) != (b, tables.shape[1] * page):
        raise ValueError(f"kv_mask must be (B, P_slot * page) = {(b, tables.shape[1] * page)}, "
                         f"got {tuple(kv_mask.shape)}")
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if tuple(x.shape) != (b, *window, kh, d):
            raise ValueError(f"{name} must be {'(B, W, K, D)' if window else '(B, K, D)'} = {(b, *window, kh, d)}, "
                             f"got {tuple(x.shape)}")
    if quantized:
        for name, x in (("pool_k_scale", pool_k_scale), ("pool_v_scale", pool_v_scale)):
            if tuple(x.shape) != tuple(pool_k.shape[:3]):
                raise ValueError(f"{name} must be (P, K, page) = {tuple(pool_k.shape[:3])}, got {tuple(x.shape)}")
            if x.dtype != torch.float32 or not x.is_contiguous() or x.device != q.device:
                raise ValueError(f"{name} must be a contiguous float32 tensor on {q.device}")
    for name, x in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v), ("k_new", k_new), ("v_new", v_new)):
        if not x.is_contiguous():
            raise ValueError(f"paged kernel takes contiguous tensors; {name} is not")
        if x.device.type == "cuda" and x.data_ptr() % 16:
            raise ValueError(f"paged kernel takes 16-byte aligned tensors; {name} is not")
    for name, x in (("pool_k", pool_k), ("pool_v", pool_v), ("tables", tables), ("kv_mask", kv_mask),
                    ("k_new", k_new), ("v_new", v_new)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def scale_window(scale_pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(P_total, K, page) scales -> each slot's (B, K, S_max) float32 window
    (the Pallas launcher's gather; the CUDA kernels read the scale pools
    through the page table themselves)."""
    b, p_slot = tables.shape
    _, kh, page = scale_pool.shape
    g = scale_pool[tables.long()]  # (B, P_slot, K, page)
    return g.permute(0, 2, 1, 3).reshape(b, kh, p_slot * page).float().contiguous()


# Per (device, kernel): (slot, KV head) ticket counters, zeroed once here and
# left zero by every launch, so no launch has to clear them. A buffer that
# grows is replaced, and the old one kept, so a CUDA graph that captured it
# still replays into live memory.
_COUNTERS: dict = {}
_RETIRED: list = []


def _counters(device: torch.device, symbol: str, n: int) -> torch.Tensor:
    buf = _COUNTERS.get((device, symbol))
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{symbol}: its ticket counters must be allocated and zeroed before a CUDA graph "
                               f"captures it; launch it once at this batch outside the capture first")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[(device, symbol)] = buf
    return buf


def _launch(q, pool_k, pool_v, tables, kv_mask, k_new, v_new, pool_k_scale, pool_v_scale, scale,
            splits: Optional[int] = None) -> torch.Tensor:
    """Launch the decode kernel (q (B, N, D)) or the window kernel (q (B, W, N, D)).

    ``splits`` forces the number of stored-window parts (tests and on-card
    checks); by default ``planned_splits``. Nothing here waits on the device.

    Each kernel keeps one set of ticket counters per device, which every
    launch leaves at zero: launches of one kernel on one device must not run
    at once, so issue them on one stream (or order the streams), and replay a
    CUDA graph that holds them only where no other launch of that kernel runs
    beside it."""
    check_kernel_shapes(q, pool_k, pool_v, tables, kv_mask, k_new, v_new, pool_k_scale, pool_v_scale)
    b, n, d = q.shape[0], q.shape[-2], q.shape[-1]
    w = q.shape[1] if q.ndim == 4 else 1
    _, kh, page, _ = pool_k.shape
    p_slot = tables.shape[1]
    if splits is None:
        splits = planned_splits(q, pool_k, tables)
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"paged kernels take 1 <= splits <= {MAX_SPLITS}, got {splits}")
    quantized = pool_k.dtype == torch.int8
    tables_i = tables.to(torch.int32).contiguous()
    mask_i = kv_mask.to(torch.int32).contiguous()
    scale_ptrs = (pool_k_scale.data_ptr(), pool_v_scale.data_ptr()) if quantized else (None, None)
    out = torch.empty_like(q)
    parts, rows = splits + 1, w * (n // kh)
    ws = torch.empty(b * kh * parts * rows * (d + 2), dtype=torch.float32, device=q.device)
    ws_ml = ws.data_ptr() + 4 * b * kh * parts * rows * d
    if q.ndim == 3:
        symbol, wrapper, shape = "paged_attention_fwd", paged_attention_decode, (b, n, kh, d, page, p_slot)
    else:
        symbol, wrapper, shape = "paged_window_fwd", paged_attention_window, (b, w, n, kh, d, page, p_slot)
    fn = _build.launcher(symbol.rsplit("_", 1)[0], symbol, 13,
                         [ctypes.c_int] * (len(shape) + 1) + [ctypes.c_float] + [ctypes.c_int] * 3)
    with torch.cuda.device(q.device):
        counters = _counters(q.device, symbol, b * kh)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tables_i.data_ptr(), mask_i.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), *scale_ptrs, out.data_ptr(), ws.data_ptr(), ws_ml,
            counters.data_ptr(), *shape, splits, float(scale), _DTYPES[q.dtype], int(quantized), q.device.index,
            stream,
        )
    _build.check(status, symbol)
    wrapper.launches += 1
    return out


def _dispatch(q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new, pool_k_scale, pool_v_scale,
              scale) -> torch.Tensor:
    """The plain version on a CPU tensor, the kernel on a CUDA one."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        if q.ndim == 3:
            return paged_attention_decode_reference(
                q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new, pool_k_scale, pool_v_scale, scale,
            )
        return paged_attention_gathered(
            q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new, pool_k_scale, pool_v_scale, scale,
        )
    if q.device.type != "cuda":
        what = "paged_attention_decode" if q.ndim == 3 else "paged_attention_window"
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {q.device}")
    return _launch(q, pool_k, pool_v, tables, kv_mask, k_new, v_new, pool_k_scale, pool_v_scale, scale)


def paged_attention_decode(
    q: torch.Tensor,  # (B, N, D) post-RoPE queries, one token per slot
    pool_k: torch.Tensor,  # (P_total, K, page, D)
    pool_v: torch.Tensor,  # (P_total, K, page, D)
    tables: torch.Tensor,  # (B, P_slot) physical page ids (0 = trash)
    kv_mask: torch.Tensor,  # (B, S_max) stored-position validity
    lengths: torch.Tensor,  # (B,) write cursors (the plain version's insert point)
    k_new: torch.Tensor,  # (B, K, D) current token K (post-RoPE)
    v_new: torch.Tensor,  # (B, K, D)
    *,
    pool_k_scale: Optional[torch.Tensor] = None,  # (P_total, K, page) int8 pools
    pool_v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step of attention against a paged KV pool -> (B, N, D)."""
    if q.ndim != 3:
        raise ValueError(f"paged_attention_decode takes q (B, N, D), got {tuple(q.shape)}")
    return _dispatch(q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new,
                     pool_k_scale, pool_v_scale, scale)


def paged_attention_window(
    q: torch.Tensor,  # (B, W, N, D) post-RoPE queries of the verify window
    pool_k: torch.Tensor,  # (P_total, K, page, D)
    pool_v: torch.Tensor,  # (P_total, K, page, D)
    tables: torch.Tensor,  # (B, P_slot) physical page ids (0 = trash)
    kv_mask: torch.Tensor,  # (B, S_max) stored-position validity, all below the window
    lengths: torch.Tensor,  # (B,) write cursors: window position i sits at lengths + i
    k_new: torch.Tensor,  # (B, W, K, D) the window's K (post-RoPE)
    v_new: torch.Tensor,  # (B, W, K, D)
    *,
    pool_k_scale: Optional[torch.Tensor] = None,  # (P_total, K, page) int8 pools
    pool_v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """A speculative verify window (W > 1) against a paged KV pool -> (B, W, N, D)."""
    if q.ndim != 4:
        raise ValueError(f"paged_attention_window takes q (B, W, N, D), got {tuple(q.shape)}")
    return _dispatch(q, pool_k, pool_v, tables, kv_mask, lengths, k_new, v_new,
                     pool_k_scale, pool_v_scale, scale)


paged_attention_decode.launches = 0
paged_attention_window.launches = 0
