"""The 3-body kernels (csrc/tri_3body.cu) and their plain versions.

``three_body_tet`` (one block per unique tile triple, lambda -> (i, j, k)
by the device tet_map, packed (tet(n), 1) output), ``three_body_bb3``
(the 3-D bounding box: an n x n x n grid whose blocks outside the simplex
write their zero, (n, n, n) output) and ``dummy_tet`` (the map alone,
i + j + k per block) wrap the three entry points of
``csrc/tri_3body.cu``. On a CUDA tensor a wrapper launches its kernel
through ``obs.launch.instrumented_launch`` or raises; it runs the plain
version (``three_body_tet_torch``, ``three_body_bb3_torch``,
``dummy_tet_torch``) only for a tensor on the CPU (``dummy_tet``, which
takes no tensor, for ``device="cpu"``). Each wrapper counts its launches
in ``.launches`` (``WRAPPERS`` lists them). On meta tensors (``device="meta"`` for the
dummy) a wrapper launches nothing: it returns empty outputs of the
kernel's shapes and records its work for the dry-run
(``roofline/dispatch_count.record_region``), ``.launches`` untouched.

The tiles are independent, so the plain versions compute any set of
them at once (``triplet_tiles``) with batched f32 products, TF32 off:
A = Xi Xj^T, B = Xj Xk^T, C = Xi Xk^T, s = sum((A B) * C), strict
masking A to a > b and B to b > c over global point indices.
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
from repro_torch.kernels.tri_3body import ref as R
from repro_torch.obs import launch as OBS
from repro_torch.roofline import dispatch_count as DC

SUPPORTED_BLOCKS = (64, 128)


def tet_meta(impl: str, n: int, block: int):
    return OBS.meta_exact("tri_3body.tet", "tri_3body", impl=impl,
                          kind="tet", steps=M.tet(n),
                          block_shape=(block, block, block),
                          bb_bound=n * n * n)


def bb3_meta(impl: str, n: int, block: int):
    return OBS.meta_dense("tri_3body.bb3", "tri_3body", impl=impl,
                          grid=(n, n, n), block_shape=(block, block, block),
                          tiles_domain=M.tet(n), kind="bb3")


def dummy_meta(impl: str, n: int):
    return OBS.meta_exact("tri_3body.dummy_tet", "tri_3body", impl=impl,
                          kind="tet", steps=M.tet(n), block_shape=(1, 1),
                          bb_bound=n * n * n)


def _tiles_per_side(op: str, x: torch.Tensor, block: int) -> int:
    _check(x.ndim == 2 and x.shape[0] % block == 0,
           f"{op}: x must be (N, d) with N a multiple of block {block}, "
           f"got {tuple(x.shape)}")
    return x.shape[0] // block


def _check_envelope(op: str, n: int):
    _check(M.tet(n) - 1 <= M.TET_TRACED_MAX_LAM,
           f"{op}: grid of {M.tet(n)} tiles exceeds the certified tet_map "
           f"int32 envelope (max lam {M.TET_TRACED_MAX_LAM}); use a larger "
           "block")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def triplet_tiles(x: torch.Tensor, block: int, i: torch.Tensor,
                  j: torch.Tensor, k: torch.Tensor, *, strict: bool = False,
                  with_abs: bool = False):
    """s of the tiles (i[t], j[t], k[t]) of x (N, d): (T,) f32; with
    ``with_abs`` also sum(|(A B) * C|) of each tile, the scale of its
    rounding error."""
    xt = x.float().reshape(-1, block, x.shape[1])
    xi, xj, xk = xt[i], xt[j], xt[k]
    with R.full_f32():
        a = xi @ xj.transpose(1, 2)
        b = xj @ xk.transpose(1, 2)
        c = xi @ xk.transpose(1, 2)
        if strict:
            m_ab, m_bc = R.strict_masks(i, j, k, block)
            a = torch.where(m_ab, a, 0.0)
            b = torch.where(m_bc, b, 0.0)
        p = (a @ b) * c
    s = p.sum(dim=(1, 2))
    return (s, p.abs().sum(dim=(1, 2))) if with_abs else s


def _packed_tiles(x: torch.Tensor, block: int, n: int,
                  strict: bool) -> torch.Tensor:
    coords = R.tet_coords(n, x.device)
    out = torch.empty((M.tet(n), 1), dtype=torch.float32, device=x.device)
    step = max(1, R.CHUNK_ELEMS // (block * block))
    for t0 in range(0, M.tet(n), step):
        i, j, k = coords[t0:t0 + step].unbind(1)
        out[t0:t0 + step, 0] = triplet_tiles(x, block, i, j, k,
                                             strict=strict)
    return out


def three_body_tet_torch(x: torch.Tensor, block: int, *,
                         strict: bool = False) -> torch.Tensor:
    """Plain tet launch: the tet(n) tile triples in lambda order, packed
    (tet(n), 1) f32 (the reference's ``_three_body_scan``)."""
    n = _tiles_per_side("three_body_tet", x, block)
    _check_envelope("three_body_tet", n)
    OBS.record_launch(tet_meta("torch", n, block), (x,))
    return _packed_tiles(x, block, n, strict)


def three_body_bb3_torch(x: torch.Tensor, block: int, *,
                         strict: bool = False) -> torch.Tensor:
    """Plain BB-3D: the (n, n, n) cube, simplex cells holding the packed
    values and exact zeros elsewhere (the reference's ``three_body_bb3``
    and its ``_three_body_scan_bb3``)."""
    n = _tiles_per_side("three_body_bb3", x, block)
    _check_envelope("three_body_bb3", n)
    OBS.record_launch(bb3_meta("torch", n, block), (x,))
    cube = torch.zeros((n, n, n), dtype=torch.float32, device=x.device)
    i, j, k = R.tet_coords(n, x.device).unbind(1)
    cube[i, j, k] = _packed_tiles(x, block, n, strict)[:, 0]
    return cube


def dummy_tet_torch(n: int, device="cpu") -> torch.Tensor:
    """Plain dummy kernel: (tet(n), 1) f32 holding i + j + k of each
    lambda."""
    _check_envelope("dummy_tet", n)
    OBS.record_launch(dummy_meta("torch", n), ())
    i, j, k = M.tet_map(torch.arange(M.tet(n), dtype=torch.int32,
                                     device=device))
    return (i + j + k).to(torch.float32).reshape(-1, 1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def smem_bytes(block: int, d: int) -> int:
    """Shared memory of one tile: Xi, Xj, Xk (b x d), A^T and B (b x b)
    and the 8 warp sums, in f32."""
    return 4 * (3 * block * d + 2 * block * block + 8)


def _check_kernel_input(op: str, x: torch.Tensor, block: int) -> int:
    n = _tiles_per_side(op, x, block)
    _check(x.dtype in _DTYPE_CODES and x.is_contiguous(),
           f"{op}: x must be contiguous f32 or bf16, got {x.dtype}")
    _check(block in SUPPORTED_BLOCKS
           and smem_bytes(block, x.shape[1]) <= SMEM_LIMIT,
           f"{op}: block {block} must be in {SUPPORTED_BLOCKS} and the "
           f"tile ({smem_bytes(block, x.shape[1])} bytes at d = "
           f"{x.shape[1]}) fit in {SMEM_LIMIT} bytes of shared memory: "
           "d <= 65 at block 128, d <= 259 at block 64")
    _check_envelope(op, n)
    return n


def three_body_tet(x: torch.Tensor, block: int, *,
                   strict: bool = False) -> torch.Tensor:
    """Tet launch: x (N, d) f32 or bf16 -> packed (tet(n), 1) f32, one
    block per unique tile triple, lambda = blockIdx.x."""
    if x.is_meta:
        DC.record_region("tri_3body.tet", x.shape[0], x.shape[1], block)
        return x.new_empty((M.tet(x.shape[0] // block), 1),
                           dtype=torch.float32)
    if not x.is_cuda:
        return three_body_tet_torch(x, block, strict=strict)
    n = _check_kernel_input("three_body_tet", x, block)
    lib = BUILD.load("tri_3body")
    out = torch.empty((M.tet(n), 1), dtype=torch.float32, device=x.device)
    OBS.instrumented_launch(
        tet_meta("cuda", n, block), lib.three_body_tet_launch, (x,),
        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], block,
        int(strict), _DTYPE_CODES[x.dtype], _stream_ptr(x))
    three_body_tet.launches += 1
    return out


three_body_tet.launches = 0


def three_body_bb3(x: torch.Tensor, block: int, *,
                   strict: bool = False) -> torch.Tensor:
    """BB-3D: x (N, d) -> (n, n, n) f32 over an n x n x n grid; blocks
    outside k <= j <= i write their zero and do nothing else."""
    if x.is_meta:
        DC.record_region("tri_3body.bb3", x.shape[0], x.shape[1], block)
        n = x.shape[0] // block
        return x.new_empty((n, n, n), dtype=torch.float32)
    if not x.is_cuda:
        return three_body_bb3_torch(x, block, strict=strict)
    # the tet_map envelope (n <= 1624) keeps n within gridDim.y/z
    n = _check_kernel_input("three_body_bb3", x, block)
    lib = BUILD.load("tri_3body")
    out = torch.empty((n, n, n), dtype=torch.float32, device=x.device)
    OBS.instrumented_launch(
        bb3_meta("cuda", n, block), lib.three_body_bb3_launch, (x,),
        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], block,
        int(strict), _DTYPE_CODES[x.dtype], _stream_ptr(x))
    three_body_bb3.launches += 1
    return out


three_body_bb3.launches = 0


def dummy_tet(n: int, device=DEV.DEFAULT_DEVICE) -> torch.Tensor:
    """The 3-D dummy kernel: grid tet(n), block lambda maps itself to
    (i, j, k) and writes i + j + k. Returns (tet(n), 1) f32 on
    ``device``."""
    dev = DEV.resolve(device)
    if dev.type == "meta":
        DC.record_region("tri_3body.dummy_tet", n)
        return torch.empty((M.tet(n), 1), dtype=torch.float32, device=dev)
    if dev.type != "cuda":
        return dummy_tet_torch(n, dev)
    _check(n >= 1, f"dummy_tet: n must be >= 1, got {n}")
    _check_envelope("dummy_tet", n)
    lib = BUILD.load("tri_3body")
    out = torch.empty((M.tet(n), 1), dtype=torch.float32, device=dev)
    OBS.instrumented_launch(dummy_meta("cuda", n), lib.dummy_tet_launch, (),
                            out.data_ptr(), n, _stream_ptr(out))
    dummy_tet.launches += 1
    return out


dummy_tet.launches = 0

# every kernel wrapper, by the launch name it records
WRAPPERS = {"tri_3body.tet": three_body_tet, "tri_3body.bb3": three_body_bb3,
            "tri_3body.dummy_tet": dummy_tet}
