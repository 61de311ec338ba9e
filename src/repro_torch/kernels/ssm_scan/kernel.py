"""The selective-scan kernel (csrc/ssm_scan.cu) and its plain version.

``selective_scan`` wraps ``ssm_scan_launch``: one block per (batch,
channel block) stream walks its time steps in order, one thread a
channel with that channel's N state floats in registers (the block's
rows of h0, A and h_L moved by coalesced loads and stores through
shared memory), 16 steps of Bt and Ct staged in shared memory at a time,
each decay one ex2.approx.ftz (within 2 ulp of exp, 0 below 2^-126; see
the source); the kernel takes state sizes 4, 8, 16 and 32. On a CUDA tensor
it launches the kernel through ``obs.launch.instrumented_launch`` or
raises; only for tensors on the CPU does it run the plain version,
``selective_scan_torch`` (the sequential oracle of ref.py, the same
launch recorded with impl "torch"). Either way it refuses inputs that
need a gradient: the kernel has no backward, as the reference's has
none. Launches are counted in ``selective_scan.launches``
(``WRAPPERS``). On meta tensors it launches nothing: it returns empty
outputs and records its work for the dry-run
(``roofline/dispatch_count.record_region``).

The launch record is the reference's Pallas one: grid (L / block_l,)
chunks of block_l steps over B * (D / block_d) cells. The reference
asserts that both blocks divide their axes; the model's prompts are
ragged, so here each block is halved until it divides its axis
(``chunk_len``), the rule of the model's chunk loop. h0 and the
returned state may be the same tensor (``state_out=h0``): the decode
step updates its cache in place.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as BUILD
from repro_torch.kernels.build import DTYPE_CODES as _DTYPE_CODES
from repro_torch.kernels.build import check as _check
from repro_torch.kernels.build import stream_ptr as _stream_ptr
from repro_torch.kernels.ssm_scan import ref as R
from repro_torch.obs import launch as OBS
from repro_torch.roofline import dispatch_count as DC

STATE_SIZES = (4, 8, 16, 32)  # the kernel's register tilings of a channel


def chunk_len(l: int, block: int) -> int:
    """min(block, l), halved until it divides l."""
    bl = min(block, l)
    while l % bl:
        bl //= 2
    return bl


def ssm_meta(impl: str, b: int, l: int, d: int, block_l: int, block_d: int):
    n_chunks = l // block_l
    return OBS.meta_dense("ssm_scan.selective_scan", "ssm_scan", impl=impl,
                          grid=(n_chunks,), block_shape=(block_l, block_d),
                          tiles_domain=n_chunks, kind="chunked",
                          cells=b * (d // block_d))


def _meta(impl, x, block_d, block_l):
    b, l, d = x.shape
    return ssm_meta(impl, b, l, d, chunk_len(l, block_l),
                    chunk_len(d, block_d))


def _zero_state(x, n):
    b, _, d = x.shape
    return torch.zeros((b, d, n), dtype=torch.float32, device=x.device)


def _refuse_grad(tensors):
    _check(not any(t is not None and t.requires_grad for t in tensors),
           "selective_scan: the kernel has no backward; differentiate "
           "through the model's chunked form (impl='torch')")


def selective_scan_torch(x, dt, A, Bt, Ct, h0=None, *, block_d: int = 256,
                         block_l: int = 128, state_out=None):
    """Plain version: (y (B, L, D) in x's dtype, h_L (B, D, N) f32), h_L
    written into ``state_out`` when given."""
    if h0 is None:
        h0 = _zero_state(x, A.shape[1])
    OBS.record_launch(_meta("torch", x, block_d, block_l),
                      (x, dt, A, Bt, Ct, h0))
    y, h = R.selective_scan_ref(x, dt, A, Bt, Ct, h0)
    if state_out is not None:
        h = state_out.copy_(h)
    return y.to(x.dtype), h


def _check_kernel_input(x, dt, A, Bt, Ct, h0, state_out):
    _check(x.ndim == 3 and tuple(dt.shape) == tuple(x.shape),
           f"selective_scan: x and dt must share one (B, L, D) shape, got "
           f"{tuple(x.shape)} and {tuple(dt.shape)}")
    b, l, d = x.shape
    n = A.shape[-1]
    _check(n in STATE_SIZES and l >= 1 and d >= 1,
           f"selective_scan: state size {n} must be one of {STATE_SIZES}, "
           f"L = {l} and D = {d} >= 1")
    _check(tuple(A.shape) == (d, n) and A.dtype == torch.float32,
           f"selective_scan: A must be ({d}, {n}) f32, got "
           f"{tuple(A.shape)} {A.dtype}")
    _check(tuple(Bt.shape) == tuple(Ct.shape) == (b, l, n),
           f"selective_scan: Bt and Ct must be ({b}, {l}, {n}), got "
           f"{tuple(Bt.shape)} and {tuple(Ct.shape)}")
    _check(x.dtype in _DTYPE_CODES
           and all(t.dtype == x.dtype for t in (dt, Bt, Ct)),
           f"selective_scan: x, dt, Bt, Ct must be one dtype, f32 or bf16, "
           f"got {[t.dtype for t in (x, dt, Bt, Ct)]}")
    for name, t in (("h0", h0), ("state_out", state_out)):
        _check(tuple(t.shape) == (b, d, n) and t.dtype == torch.float32,
               f"selective_scan: {name} must be ({b}, {d}, {n}) f32, got "
               f"{tuple(t.shape)} {t.dtype}")
    tensors = (x, dt, A, Bt, Ct, h0, state_out)
    _check(all(t.is_contiguous() and t.device == x.device for t in tensors),
           "selective_scan: every tensor must be contiguous on one device")


def selective_scan(x, dt, A, Bt, Ct, h0=None, *, block_d: int = 256,
                   block_l: int = 128, state_out=None):
    """x, dt (B, L, D) and Bt, Ct (B, L, N), one dtype, f32 or bf16; A
    (D, N) f32; h0 (B, D, N) f32 or None (zeros). Returns (y (B, L, D)
    in x's dtype, h_L (B, D, N) f32), h_L written into ``state_out``
    (which may be h0) when given."""
    _refuse_grad((x, dt, A, Bt, Ct, h0, state_out))
    if x.is_meta:
        b, l, d = x.shape
        DC.record_region("ssm_scan.selective_scan", b, l, d, A.shape[-1])
        if state_out is None:
            state_out = x.new_empty((b, d, A.shape[-1]), dtype=torch.float32)
        return torch.empty_like(x), state_out
    if not x.is_cuda:
        return selective_scan_torch(x, dt, A, Bt, Ct, h0, block_d=block_d,
                                    block_l=block_l, state_out=state_out)
    b, l, d = x.shape
    n = A.shape[-1]
    if h0 is None:
        h0 = _zero_state(x, n)
    if state_out is None:
        state_out = torch.empty_like(h0)
    _check_kernel_input(x, dt, A, Bt, Ct, h0, state_out)
    lib = BUILD.load("ssm_scan")
    y = torch.empty_like(x)
    OBS.instrumented_launch(
        _meta("cuda", x, block_d, block_l), lib.ssm_scan_launch,
        (x, dt, A, Bt, Ct, h0), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bt.data_ptr(), Ct.data_ptr(), h0.data_ptr(), y.data_ptr(),
        state_out.data_ptr(), b, l, d, n, _DTYPE_CODES[x.dtype],
        _stream_ptr(x))
    selective_scan.launches += 1
    return y, state_out


selective_scan.launches = 0

# every kernel wrapper, by the launch name it records
WRAPPERS = {"ssm_scan.selective_scan": selective_scan}
