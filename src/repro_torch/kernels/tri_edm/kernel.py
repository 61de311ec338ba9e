"""The paper's EDM kernels (csrc/tri_edm.cu) and their plain versions.

``edm_ltm`` (LTM: one block per lower-triangle tile, lambda -> (i, j) by
the device g(lambda), packed (tri(n), b, b) output), ``edm_bb`` (the BB
baseline: an n x n grid whose blocks above the diagonal write their zero
tile, full (N, N) output) and ``dummy_ltm`` (the paper's dummy kernel:
the mapping alone, i + j per block) wrap the three entry points of
``csrc/tri_edm.cu``. On a CUDA tensor a wrapper launches its kernel
through ``obs.launch.instrumented_launch`` or raises; it runs the plain
version (``edm_ltm_torch``, ``edm_bb_torch``, ``dummy_ltm_torch``) only
for a tensor on the CPU (``dummy_ltm``, which takes no tensor, for
``device="cpu"``). Each wrapper counts its launches in ``.launches``
(``WRAPPERS`` lists them). On meta tensors (``device="meta"`` for the
dummy) a wrapper launches nothing: it returns empty outputs of the
kernel's shapes and records its work for the dry-run
(``roofline/dispatch_count.record_region``), ``.launches`` untouched.

The tiles are independent, so the plain versions compute any set of
them at once (``edm_tiles``), with the kernel's arithmetic: squared
norms and dot products summed feature by feature with each product and
sum rounded to f32 on its own (no fused multiply-add), d^2 = max(sq_i +
sq_j - 2 <x_i, x_j>, 0), exact zero self-distance, then sqrt.
"""

from __future__ import annotations

import torch

from repro_torch import device as DEV
from repro_torch.core import mapping as M
from repro_torch.kernels import build as BUILD
from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.build import DTYPE_CODES as _DTYPE_CODES
from repro_torch.kernels.build import check as _check
from repro_torch.kernels.build import stream_ptr as _stream_ptr
from repro_torch.kernels.tri_edm import ref as R
from repro_torch.obs import launch as OBS
from repro_torch.roofline import dispatch_count as DC

SUPPORTED_BLOCKS = (8, 16, 32, 64, 128)
# tiles a plain version computes at once (bounds its temporaries)
_CHUNK_ELEMS = 1 << 26


def ltm_meta(impl: str, n: int, block: int):
    return OBS.meta_exact("tri_edm.ltm", "tri_edm", impl=impl, kind="ltm",
                          steps=M.tri(n), block_shape=(block, block),
                          bb_bound=n * n)


def bb_meta(impl: str, n: int, block: int):
    return OBS.meta_dense("tri_edm.bb", "tri_edm", impl=impl, grid=(n, n),
                          block_shape=(block, block), tiles_domain=M.tri(n))


def dummy_meta(impl: str, n: int):
    return OBS.meta_exact("tri_edm.dummy_ltm", "tri_edm", impl=impl,
                          kind="ltm", steps=M.tri(n), block_shape=(1, 1),
                          bb_bound=n * n)


def _tiles_per_side(op: str, x: torch.Tensor, block: int) -> int:
    _check(x.ndim == 2 and x.shape[0] % block == 0,
           f"{op}: x must be (N, d) with N a multiple of block {block}, "
           f"got {tuple(x.shape)}")
    return x.shape[0] // block


def _check_envelope(op: str, n: int):
    _check(M.tri(n) - 1 <= M.LTM_TRACED_MAX_LAM,
           f"{op}: grid of {M.tri(n)} tiles exceeds the certified ltm_map "
           f"int32 envelope (max lam {M.LTM_TRACED_MAX_LAM}); use a larger "
           "block")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _sum_of_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] * b[..., k] feature by feature, each product and
    each sum rounded to f32 on its own, as the kernel sums."""
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k] * b[..., k]
    return acc


def edm_tiles(x: torch.Tensor, block: int, i: torch.Tensor, j: torch.Tensor,
              *, squared: bool = False) -> torch.Tensor:
    """EDM tiles (i[t], j[t]) of x (N, d): (len(i), block, block) f32."""
    xt = x.float().reshape(-1, block, x.shape[1])
    xi, xj = xt[i], xt[j]  # (T, b, d)
    sqi = _sum_of_products(xi, xi)
    sqj = _sum_of_products(xj, xj)
    dot = _sum_of_products(xi[:, :, None, :], xj[:, None, :, :])
    d2 = ((sqi[:, :, None] + sqj[:, None, :]) - 2.0 * dot).clamp_min(0.0)
    self_pair = (i == j)[:, None, None] & torch.eye(
        block, dtype=torch.bool, device=x.device)
    d2 = torch.where(self_pair, 0.0, d2)
    return d2 if squared else torch.sqrt(d2)


def edm_ltm_torch(x: torch.Tensor, block: int, *,
                  squared: bool = False) -> torch.Tensor:
    """Plain LTM: the tri(n) lower-triangle tiles in lambda order, packed
    (tri(n), block, block) f32 (the reference's ``_edm_scan``)."""
    n = _tiles_per_side("edm_ltm", x, block)
    _check_envelope("edm_ltm", n)
    OBS.record_launch(ltm_meta("torch", n, block), (x,))
    i, j = R.tile_coords(n, x.device)
    out = torch.empty((M.tri(n), block, block), dtype=torch.float32,
                      device=x.device)
    step = max(1, _CHUNK_ELEMS // (block * block * x.shape[1]))
    for t0 in range(0, M.tri(n), step):
        out[t0:t0 + step] = edm_tiles(x, block, i[t0:t0 + step],
                                      j[t0:t0 + step], squared=squared)
    return out


def edm_bb_torch(x: torch.Tensor, block: int, *,
                 squared: bool = False) -> torch.Tensor:
    """Plain BB: the full (N, N) f32 matrix, tiles with j <= i computed
    row by row and the rest zero (the reference's ``edm_bb`` and its
    ``_edm_scan_bb``)."""
    n = _tiles_per_side("edm_bb", x, block)
    OBS.record_launch(bb_meta("torch", n, block), (x,))
    rows = x.shape[0]
    out = torch.zeros((rows, rows), dtype=torch.float32, device=x.device)
    for i in range(n):
        cols = torch.arange(i + 1, device=x.device)
        tiles = edm_tiles(x, block, torch.full_like(cols, i), cols,
                          squared=squared)
        out[i * block:(i + 1) * block, :(i + 1) * block] = \
            tiles.permute(1, 0, 2).reshape(block, (i + 1) * block)
    return out


def dummy_ltm_torch(n: int, device="cpu") -> torch.Tensor:
    """Plain dummy kernel: (tri(n), 1) f32 holding i + j of each lambda."""
    _check_envelope("dummy_ltm", n)
    OBS.record_launch(dummy_meta("torch", n), ())
    i, j = R.tile_coords(n, device)
    return (i + j).to(torch.float32).reshape(-1, 1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check_kernel_input(op: str, x: torch.Tensor, block: int) -> int:
    n = _tiles_per_side(op, x, block)
    _check(x.dtype in _DTYPE_CODES and x.is_contiguous(),
           f"{op}: x must be contiguous f32 or bf16, got {x.dtype}")
    smem = 4 * (2 * block * x.shape[1] + 2 * block)
    _check(block in SUPPORTED_BLOCKS and smem <= SMEM_LIMIT,
           f"{op}: block {block} must be in {SUPPORTED_BLOCKS} and the two "
           f"row tiles ({smem} bytes at d = {x.shape[1]}) fit in "
           f"{SMEM_LIMIT} bytes of shared memory")
    return n


def edm_ltm(x: torch.Tensor, block: int, *,
            squared: bool = False) -> torch.Tensor:
    """LTM EDM: x (N, d) f32 or bf16 -> packed (tri(n), block, block) f32,
    one block per tile, lambda = blockIdx.x."""
    if x.is_meta:
        DC.record_region("tri_edm.ltm", x.shape[0], x.shape[1], block)
        n = x.shape[0] // block
        return x.new_empty((M.tri(n), block, block), dtype=torch.float32)
    if not x.is_cuda:
        return edm_ltm_torch(x, block, squared=squared)
    n = _check_kernel_input("edm_ltm", x, block)
    _check_envelope("edm_ltm", n)
    lib = BUILD.load("tri_edm")
    out = torch.empty((M.tri(n), block, block), dtype=torch.float32,
                      device=x.device)
    OBS.instrumented_launch(
        ltm_meta("cuda", n, block), lib.edm_ltm_launch, (x,), x.data_ptr(),
        out.data_ptr(), x.shape[0], x.shape[1], block, int(squared),
        _DTYPE_CODES[x.dtype], _stream_ptr(x))
    edm_ltm.launches += 1
    return out


edm_ltm.launches = 0


def edm_bb(x: torch.Tensor, block: int, *,
           squared: bool = False) -> torch.Tensor:
    """BB EDM: x (N, d) -> full (N, N) f32 over an n x n grid; blocks with
    j > i write their zero tile and do nothing else."""
    if x.is_meta:
        DC.record_region("tri_edm.bb", x.shape[0], x.shape[1], block)
        return x.new_empty((x.shape[0], x.shape[0]), dtype=torch.float32)
    if not x.is_cuda:
        return edm_bb_torch(x, block, squared=squared)
    n = _check_kernel_input("edm_bb", x, block)
    _check(n <= 65535, f"edm_bb: {n} tile rows exceed gridDim.y (65535)")
    lib = BUILD.load("tri_edm")
    out = torch.empty((x.shape[0], x.shape[0]), dtype=torch.float32,
                      device=x.device)
    OBS.instrumented_launch(
        bb_meta("cuda", n, block), lib.edm_bb_launch, (x,), x.data_ptr(),
        out.data_ptr(), x.shape[0], x.shape[1], block, int(squared),
        _DTYPE_CODES[x.dtype], _stream_ptr(x))
    edm_bb.launches += 1
    return out


edm_bb.launches = 0


def dummy_ltm(n: int, device=DEV.DEFAULT_DEVICE) -> torch.Tensor:
    """The paper's dummy kernel: grid tri(n), block lambda maps itself to
    (i, j) and writes i + j. Returns (tri(n), 1) f32 on ``device``."""
    dev = DEV.resolve(device)
    if dev.type == "meta":
        DC.record_region("tri_edm.dummy_ltm", n)
        return torch.empty((M.tri(n), 1), dtype=torch.float32, device=dev)
    if dev.type != "cuda":
        return dummy_ltm_torch(n, dev)
    _check(n >= 1, f"dummy_ltm: n must be >= 1, got {n}")
    _check_envelope("dummy_ltm", n)
    lib = BUILD.load("tri_edm")
    out = torch.empty((M.tri(n), 1), dtype=torch.float32, device=dev)
    OBS.instrumented_launch(dummy_meta("cuda", n), lib.dummy_ltm_launch, (),
                            out.data_ptr(), n, _stream_ptr(out))
    dummy_ltm.launches += 1
    return out


dummy_ltm.launches = 0


def empty_blocks(blocks: int, device=DEV.DEFAULT_DEVICE) -> None:
    """``blocks`` empty one-warp blocks on a 1-D grid (tri_edm.cu's
    empty_blocks_launch): the dummy kernels' geometry without their work,
    a yardstick of the card's block dispatch that no path of the port
    runs. CUDA only; no plain version, no counter."""
    dev = DEV.resolve(device)
    _check(dev.type == "cuda" and blocks >= 1,
           f"empty_blocks: a CUDA device and blocks >= 1, got {dev} and "
           f"{blocks}")
    meta = OBS.meta_exact("tri_edm.empty_blocks", "tri_edm", impl="cuda",
                          kind="yardstick", steps=blocks, block_shape=(1, 1),
                          bb_bound=None)
    OBS.instrumented_launch(meta, BUILD.load("tri_edm").empty_blocks_launch,
                            (), blocks,
                            torch.cuda.current_stream(dev).cuda_stream)


# every kernel wrapper, by the launch name it records
WRAPPERS = {"tri_edm.ltm": edm_ltm, "tri_edm.bb": edm_bb,
            "tri_edm.dummy_ltm": dummy_ltm}
