"""SAMD convolutions: the CUDA kernels and their plain PyTorch versions.

Counterpart of ``repro/kernels/samd_conv.py``; both kernels are in
``csrc/samd_conv.cu``:

- ``samd_conv2d_launch`` and ``samd_conv2d_im2col_launch`` replace the
  Pallas kernel ``samd_conv2d``: a stride-1 2D conv of x [C_in, H, W]
  with packed HWIO weights [KH, KW, ceil(C_in/vpw), C_out] -> [OH, OW,
  C_out], the scale applied once per output channel. Both run one
  tensor-core implicit GEMM (output pixels x C_out x KH*KW*C_in) over a
  bf16 workspace that a pre-pass fills from x: pixel-major with its
  padding (each tap a row offset), or, for layers with few channels,
  the KH*KW*C_in products of each pixel side by side.
  :func:`conv2d_plan` is the rule that picks the launcher, the K-step and
  the K split from the shape. ``samd_conv2d_plain`` is the reference's
  ``samd_conv2d_xla`` in PyTorch: per block of C_in words and per (kh,
  kw), unpack the codes, cast them through x's dtype (the reference's
  ``codes.astype(x.dtype)``) and contract the shifted window in f32.
- ``samd_conv1d_launch`` is the op users call, ``ops.samd_conv1d``,
  fused: the raw integer values x [n] and the kernel values k [taps] ->
  int32 [n + taps - 1] (``np.convolve``), the packing in its loads and the
  overlap-add of the chunks' lanes in its epilogue. :func:`conv1d_plan`
  gives its tiles and grid. Its plain version, ``samd_conv1d_plain``, is
  the composition the reference runs: ``pack_conv_operand`` -> the chunk
  products -> ``overlap_add``.
- ``samd_conv_chunks_launch`` replaces ``samd_conv_chunks``: each packed
  chunk word times the kernel word (conv as long multiplication, §5-6),
  extracted to int32 [nc, lanes + taps - 1]. ``samd_conv_chunks_plain``
  is ``core.conv.chunk_products`` + ``extract_outputs`` (16-bit limbs, as
  the reference); the kernel's output is bit-identical to it. Both
  launchers share one device function for the product, fixup and
  extraction.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.conv import (
    ConvPlan,
    chunk_products,
    extract_outputs,
    overlap_add,
    pack_conv_kernel,
    pack_conv_operand,
)
from repro_torch.kernels._build import Kernel, ptr, stream_handle
from repro_torch.kernels.samd_matmul import unpack_codes
from repro_torch.quant.config import QuantConfig

DIRECT = "samd_conv2d_launch"
IM2COL = "samd_conv2d_im2col_launch"
CONV1D = "samd_conv1d_launch"
CHUNKS = "samd_conv_chunks_launch"
_CONV2D_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                + [ctypes.c_int] * 16 + [ctypes.c_void_p])
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel(
    "samd_conv", "samd_conv.cu",
    {DIRECT: _CONV2D_ARGS, IM2COL: _CONV2D_ARGS,
     CONV1D: [_P, _LL, _LL, _P, _LL, _I, _P, _LL] + [_I] * 9 + [_P],
     CHUNKS: [_P] * 3 + [_I] * 4 + [_P]},
)
# output pixels x output channels of one block of the conv2d kernel
BLOCK_M, BLOCK_N = 128, 64
# words of channels per K-step for each lanes-per-word count: a step is a
# multiple of 16 values of K (the MMA's k), 32-80; bf16 x (one term where
# f32 x runs two) takes twice the words where that makes 32 values from
# at most 8 words. The kernel is compiled for these steps and refuses a
# plan whose step is not its own.
STEP_WORDS = {1: 32, 2: 16, 3: 16, 4: 8, 5: 16, 6: 8, 8: 4, 10: 8, 16: 2,
              32: 1}
ONE_TERM_MULT = 2
MAX_SPLITS = 8    # K splits of one tile form one cluster: the portable size
NUM_SMS = 132     # H100 SXM
# channels the plain version takes per reduction step (rounded to whole
# words)
BLOCK_C = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Conv2dPlan:
    """How the conv2d kernel runs one shape: its launcher, the values of K
    per step, the number of steps, the K splits (a divisor of the steps),
    the output tiles and the workspace (x terms x rows x bf16 columns).
    The kernel takes ``step_k`` and ``steps`` as they are and lays its
    workspace out from them."""

    launcher: str
    step_k: int
    steps: int
    splits: int
    tiles: int
    ws_rows: int
    ws_cols: int
    terms: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def ws_elems(self) -> int:
        return self.terms * self.ws_rows * self.ws_cols


@functools.lru_cache(maxsize=4096)
def conv2d_plan(c_in: int, cw: int, h: int, w: int, kh: int, kw: int,
                c_out: int, padding: int, vpw: int, x_bf16: bool,
                launcher: str | None = None) -> Conv2dPlan:
    """The rule for the conv2d kernel, for x [c_in, h, w] and packed
    weights [kh, kw, cw, c_out]. A K-step is one tap's ``STEP_WORDS[vpw]``
    words of channels (twice that for bf16 x where it makes 32 values
    from at most 8 words), so a tap takes ceil(cw / words) steps; where
    that pads the channels so far that writing each pixel's KH*KW*C_in
    products side by side takes at most half the steps (conv1_1's 27
    products: one step against 9), the im2col launcher runs, else the
    direct one (``launcher`` names one instead, to compare the two). f32 x
    runs as two bf16 terms. K is split only where the output tiles fill
    fewer than ``NUM_SMS`` SMs: into the largest divisor of the steps, at
    most ``MAX_SPLITS``, that keeps the blocks within two per SM (one
    wave)."""
    sw = STEP_WORDS[vpw]
    if x_bf16 and sw * vpw == 32 and sw <= 8:
        sw *= ONE_TERM_MULT
    step_k = sw * vpw
    taps = kh * kw
    oh, ow = h + 2 * padding - kh + 1, w + 2 * padding - kw + 1
    chunks = _cdiv(cw, sw)
    im2col_steps = _cdiv(taps * c_in, step_k)
    if launcher is None:
        launcher = IM2COL if 2 * im2col_steps <= taps * chunks else DIRECT
    if launcher == IM2COL:
        steps = im2col_steps
        rows, cols, m = oh * ow, im2col_steps * step_k, oh * ow
    elif launcher == DIRECT:
        steps = taps * chunks
        wp = w + 2 * padding
        rows, cols, m = (h + 2 * padding) * wp, chunks * step_k, oh * wp
    else:
        raise ValueError(f"no conv2d launcher {launcher!r}")
    tiles = _cdiv(m, BLOCK_M) * _cdiv(c_out, BLOCK_N)
    splits = 1
    if tiles < NUM_SMS:
        splits = max(d for d in range(1, MAX_SPLITS + 1)
                     if steps % d == 0 and (d == 1 or
                                            tiles * d <= 2 * NUM_SMS))
    return Conv2dPlan(launcher, step_k, steps, splits, tiles, rows, cols,
                      1 if x_bf16 else 2)


def block_words(vpw: int) -> int:
    """Words of C_in per reduction step at ``vpw`` values a word."""
    return max(1, BLOCK_C // vpw)


def conv2d_shape(x: torch.Tensor, packed: torch.Tensor, cfg: QuantConfig,
                 padding: int):
    """(OH, OW, C_out) of the conv; raises on inconsistent operands."""
    if x.dim() != 3 or packed.dim() != 4:
        raise ValueError(f"x must be [C_in, H, W] and packed [KH, KW, CW, "
                         f"C_out], got {tuple(x.shape)} and "
                         f"{tuple(packed.shape)}")
    c_in, h, w = x.shape
    kh, kw, cw, n = packed.shape
    if cw * cfg.values_per_word < c_in:
        raise ValueError(f"{cw} packed words cannot hold C_in={c_in}")
    oh, ow = h + 2 * padding - kh + 1, w + 2 * padding - kw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"a {kh}x{kw} kernel does not fit {h}x{w} with "
                         f"padding {padding}")
    return oh, ow, n


def samd_conv2d_plain(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor, cfg: QuantConfig, *,
                      padding: int = 1,
                      signed: bool = True) -> torch.Tensor:
    """The blocked conv loop in PyTorch; returns [OH, OW, C_out] in x's
    dtype. C_in is contracted in steps of ``BLOCK_C`` channels,
    zero-padded to whole steps, and the image by ``padding``, as the
    reference's ``_pad_conv_operands``. The codes are cast through x's
    dtype, as the reference's ``codes.astype(x.dtype)``: exact up to 8
    unsigned / 9 signed bits, rounded above that for bf16 x."""
    oh, ow, n = conv2d_shape(x, packed, cfg, padding)
    kh_taps, kw_taps, cw, _ = packed.shape
    vpw = cfg.values_per_word
    bcw = min(block_words(vpw), cw)
    cwp = -(-cw // bcw) * bcw
    packed = torch.nn.functional.pad(packed, (0, 0, 0, cwp - cw))
    xp = torch.nn.functional.pad(
        x.to(torch.float32),
        (padding, padding, padding, padding, 0, cwp * vpw - x.shape[0]))
    bc = bcw * vpw
    acc = torch.zeros((oh * ow, n), dtype=torch.float32, device=x.device)
    for cb in range(cwp // bcw):
        xb = xp[cb * bc:(cb + 1) * bc]
        for i in range(kh_taps):
            for j in range(kw_taps):
                codes = unpack_codes(packed[i, j, cb * bcw:(cb + 1) * bcw],
                                     cfg.bits, cfg.lane_width, signed)
                patch = xb[:, i:i + oh, j:j + ow].reshape(bc, oh * ow)
                acc += patch.t() @ codes.to(x.dtype).to(torch.float32)
    out = acc * scale.reshape(1, n).to(torch.float32)
    return out.reshape(oh, ow, n).to(x.dtype)


def conv2d_launch_args(x: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor, cfg: QuantConfig, *,
                       padding: int = 1, signed: bool = True,
                       launcher: str | None = None):
    """Check the operands of the conv2d kernel and make its launch: the
    plan of :func:`conv2d_plan` (or of ``launcher``), the output, the
    workspace (keep it alive until the launch is queued) and the
    launcher's arguments. Takes f32 or bf16 ``x``, int32 words and f32
    scales, all on one CUDA device; raises on anything else."""
    oh, ow, n = conv2d_shape(x, packed, cfg, padding)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"samd_conv2d kernel takes f32 or bf16 x, got "
                        f"{x.dtype}")
    if packed.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError(f"packed must be int32 and scale f32, got "
                        f"{packed.dtype}/{scale.dtype}")
    if scale.numel() != n:
        raise ValueError(f"scale has {scale.numel()} entries for C_out={n}")
    dev = x.get_device()
    if packed.get_device() != dev or scale.get_device() != dev:
        raise ValueError("x, packed and scale must share one CUDA device")
    x, packed, scale = x.contiguous(), packed.contiguous(), scale.contiguous()
    c_in, h, w = x.shape
    kh, kw, cw, _ = packed.shape
    vpw = cfg.values_per_word
    x_bf16 = x.dtype == torch.bfloat16
    plan = conv2d_plan(c_in, cw, h, w, kh, kw, n, padding, vpw, x_bf16,
                       launcher)
    out = torch.empty((oh, ow, n), dtype=x.dtype, device=x.device)
    ws = torch.empty(plan.ws_elems, dtype=torch.bfloat16, device=x.device)
    args = (x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            out.data_ptr(), ws.data_ptr(), plan.ws_elems, c_in, h, w, kh, kw,
            cw, n, padding, cfg.bits, cfg.lane_width, vpw, int(signed),
            int(x_bf16), plan.splits, plan.step_k, plan.steps,
            stream_handle(x))
    return plan, out, ws, args


def samd_conv2d_cuda(x: torch.Tensor, packed: torch.Tensor,
                     scale: torch.Tensor, cfg: QuantConfig, *,
                     padding: int = 1, signed: bool = True) -> torch.Tensor:
    """Launch the conv2d kernel on the current stream, by the launcher of
    :func:`conv2d_plan`; operands as :func:`conv2d_launch_args`. Raises on
    bad operands and on a failed build or launch."""
    plan, out, _ws, args = conv2d_launch_args(x, packed, scale, cfg,
                                              padding=padding, signed=signed)
    _launch_on(x, plan.launcher, *args)
    return out


# -- conv as long multiplication --------------------------------------------

# x's integer types, by the launcher's code (one kernel instantiation each)
INT_CODES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.int32: 3,
             torch.int64: 4}
_INT_NAMES = ", ".join(str(d)[6:] for d in INT_CODES)
# chunks a tile, at most, and bytes of x's values a tile, at most (fewer
# chunks where lanes x itemsize is wide); persistent blocks an SM, the
# source's register bound. Two tile buffers of at most 20 KB, the 8-byte
# products of at most 513 chunks and the kernel word stay under the 48 KB
# a block may take without opting in, for every plan and dtype (the
# launcher refuses a tile that does not fit). tools/conv1d_ablation.py
# sweeps both: 256-1024 chunks and 3-4 blocks are within 3% of each other.
C1D_TILE_CHUNKS = 512
C1D_TILE_BYTES = 20 * 1024
C1D_BLOCKS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class Conv1dPlan:
    """How the fused conv1d kernel covers one signal: ``tiles`` tiles of
    ``tile_chunks`` chunks of ``lanes`` values, taken by ``blocks``
    persistent blocks (block i takes tiles i, i + blocks, ...). Tile b
    reads the values and writes the outputs of chunks [b * tile_chunks,
    (b + 1) * tile_chunks), the last tile only up to ``n_out``, and
    recomputes the chunk before its first (the halo), whose high lanes
    reach its first outputs."""

    n: int
    n_out: int
    lanes: int
    chunks: int
    tile_chunks: int
    tiles: int
    blocks: int

    def tile(self, b: int) -> tuple[int, int, int, int]:
        """(halo chunk, first chunk, stop chunk, stop output) of tile b;
        a halo of -1 is the zero chunk before the signal."""
        first = b * self.tile_chunks
        stop = min(first + self.tile_chunks, self.chunks)
        return first - 1, first, stop, min(stop * self.lanes, self.n_out)


@functools.lru_cache(maxsize=4096)
def conv1d_plan(n: int, plan: ConvPlan, dtype: torch.dtype) -> Conv1dPlan:
    """The fused kernel's tiles for x [n] of ``dtype`` under ``plan``:
    output chunks of ``lanes`` outputs cover the n + taps - 1 outputs
    (those past x's last value take only the tail of the chunk before),
    a tile the most chunks, in whole 16-chunk groups, up to
    ``C1D_TILE_CHUNKS`` whose values take at most ``C1D_TILE_BYTES``;
    ``C1D_BLOCKS_PER_SM`` blocks an SM, no more than the tiles. Raises
    ``TypeError`` for an x the kernel does not take."""
    if dtype not in INT_CODES:
        raise TypeError(f"samd_conv1d kernel takes x of {_INT_NAMES}, "
                        f"got {dtype}")
    lanes = plan.lanes_per_chunk
    n_out = n + plan.taps - 1
    chunks = _cdiv(n_out, lanes)
    tile = max(16, min(C1D_TILE_CHUNKS,
                       C1D_TILE_BYTES // (lanes * dtype.itemsize)) // 16 * 16)
    tiles = _cdiv(chunks, tile)
    return Conv1dPlan(n, n_out, lanes, chunks, tile, tiles,
                      min(tiles, C1D_BLOCKS_PER_SM * NUM_SMS))


def samd_conv1d_plain(x: torch.Tensor, kernel: torch.Tensor,
                      plan: ConvPlan) -> torch.Tensor:
    """The op as the reference composes it: ``pack_conv_operand`` ->
    :func:`samd_conv_chunks_plain` -> ``overlap_add``; x [..., n] int,
    kernel [taps] int -> [..., n + taps - 1] int32."""
    lanes = samd_conv_chunks_plain(pack_conv_operand(x, plan),
                                   pack_conv_kernel(kernel, plan), plan)
    return overlap_add(lanes, plan, x.shape[-1] + plan.taps - 1)


def conv1d_launch_args(x: torch.Tensor, kernel: torch.Tensor,
                       plan: ConvPlan):
    """Check the operands of the fused conv1d kernel and make its launch:
    the :func:`conv1d_plan`, the int32 output [n + taps - 1] and the
    launcher's arguments. Takes x [n] and kernel [plan.taps] of integer
    types of ``INT_CODES``, each of any stride, both on one CUDA device;
    raises on anything else."""
    check_kernel_word_bits(plan)
    plan.validate()
    if x.dim() != 1 or kernel.dim() != 1 or kernel.shape[0] != plan.taps:
        raise ValueError(f"x must be [n] and kernel [{plan.taps}], got "
                         f"{tuple(x.shape)}/{tuple(kernel.shape)}")
    if kernel.dtype not in INT_CODES:
        raise TypeError(f"kernel must be one of {_INT_NAMES}, got "
                        f"{kernel.dtype}")
    if kernel.device != x.device:
        raise ValueError("x and kernel must share one CUDA device")
    n = x.shape[0]
    p = conv1d_plan(n, plan, x.dtype)
    out = torch.empty(p.n_out, dtype=torch.int32, device=x.device)
    fmt = plan.fmt
    args = (x.data_ptr(), n, x.stride(0), kernel.data_ptr(),
            kernel.stride(0), INT_CODES[kernel.dtype], out.data_ptr(), p.n_out, p.tile_chunks,
            p.tiles, p.blocks, fmt.lane_width, p.lanes, plan.taps, fmt.bits,
            int(fmt.signed), INT_CODES[x.dtype], stream_handle(x))
    return p, out, args


def samd_conv1d_cuda(x: torch.Tensor, kernel: torch.Tensor,
                     plan: ConvPlan) -> torch.Tensor:
    """Launch ``samd_conv1d_launch`` on the current stream -> int32
    [n + taps - 1]; operands as :func:`conv1d_launch_args`. One launch
    and no other device op; raises on bad operands and on a failed build
    or launch."""
    p, out, args = conv1d_launch_args(x, kernel, plan)
    if p.n_out:
        _launch_on(x, CONV1D, *args)
    return out


def _launch_on(t: torch.Tensor, fn: str, *args) -> None:
    """Launch ``fn``, entering ``t``'s device only when it is not the
    current one."""
    dev = t.get_device()
    if dev == torch.cuda.current_device():
        KERNEL.launch(fn, *args)
    else:
        with torch.cuda.device(dev):
            KERNEL.launch(fn, *args)


def check_kernel_word_bits(plan: ConvPlan) -> None:
    """Raise ValueError unless ``plan`` has 32-bit words: the conv1d
    kernels multiply 32-bit words, as the TPU kernel they port does."""
    if plan.fmt.word_bits != 32:
        raise ValueError(
            "the fused samd_conv1d kernel, like the TPU kernel it ports, "
            f"multiplies 32-bit words; a {plan.fmt.word_bits}-bit plan runs "
            "through repro_torch.core.conv.samd_conv_full")


def samd_conv_chunks_plain(x_words: torch.Tensor, k_word: torch.Tensor,
                           plan: ConvPlan) -> torch.Tensor:
    """[nc] chunk words x the kernel word -> int32 [nc, out_lanes]."""
    return extract_outputs(*chunk_products(x_words, k_word, plan), plan)


def samd_conv_chunks_cuda(x_words: torch.Tensor, k_word: torch.Tensor,
                          plan: ConvPlan) -> torch.Tensor:
    """Launch ``samd_conv_chunks_launch`` on the current stream: int32
    chunk words [nc] and a one-element int32 kernel word on one CUDA
    device; raises on anything else."""
    check_kernel_word_bits(plan)
    plan.validate()
    dev = x_words.device
    if x_words.dtype != torch.int32 or k_word.dtype != torch.int32:
        raise TypeError(f"words must be int32, got {x_words.dtype}/"
                        f"{k_word.dtype}")
    if x_words.dim() != 1 or k_word.numel() != 1:
        raise ValueError(f"x_words must be [nc] and k_word one word, got "
                         f"{tuple(x_words.shape)}/{tuple(k_word.shape)}")
    if k_word.device != dev:
        raise ValueError("x_words and k_word must share one CUDA device")
    x_words, k_word = x_words.contiguous(), k_word.contiguous()
    nc, lanes = x_words.shape[0], plan.out_lanes_per_chunk
    out = torch.empty((nc, lanes), dtype=torch.int32, device=dev)
    if nc == 0:
        return out
    _launch_on(x_words, CHUNKS, ptr(x_words), ptr(k_word), ptr(out), nc,
               plan.fmt.lane_width, lanes, int(plan.fmt.signed),
               stream_handle(x_words))
    return out
