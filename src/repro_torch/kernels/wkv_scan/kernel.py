"""The WKV6 kernel (csrc/wkv_scan.cu) and its plain version.

``wkv`` wraps ``wkv_launch``: each (batch, head) stream is split over
time into chunks of WKV_CHUNK steps, a block a (stream, chunk), chained
in the same launch (see the source). Chunk 0 walks from s0; every other
chunk walks from a zero state, waits for its predecessor's state S_{c-1},
publishes S_c = diag(prod e^{lw}) S_{c-1} + its own, and adds
(r_t * prod_{tau < t} e^{lw_tau}) S_{c-1} to its outputs. The chunked
sums round otherwise than the sequential walk (the card holds them to
WKV_REL of the plain version). A call of L <= WKV_CHUNK (every decode
step) is one chunk and launches the sequential walk instead, one block a
stream, bitwise equal to L one-step calls. The kernel takes head sizes
8, 16, 32 and 64 and
16-byte aligned r, k, v, lw. On a CUDA tensor it launches the kernel
through ``obs.launch.instrumented_launch`` or raises; only for tensors
on the CPU does it run the plain version, ``wkv_torch`` (the sequential
oracle of ref.py, the same launch recorded with impl "torch"). Launches
are counted in ``wkv.launches`` (``WRAPPERS``). On meta tensors it
launches nothing: it returns empty outputs and records its work for the
dry-run (``roofline/dispatch_count.record_region``).

The launch record is the reference's Pallas one: grid (L / block_l,)
chunks of block_l time steps, B * H cells. The reference asserts that
block_l divides L; the model's prompts are ragged, so here block_l is
halved until it divides L (``chunk_len``), the rule of the model's
chunk loop. block_l names the record only: the kernel's chunk is
WKV_CHUNK. s0 and the returned state may be the same tensor
(``state_out=s0``): the decode step updates its cache in place. The
wrapper gives a call of more than one chunk a (B, H, hd, hd) f32 slot
for the published states and 1 + B * H counters (``arrival_counters``:
the ticket counter and each stream's published chunks, 0 between
launches).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as BUILD
from repro_torch.kernels.build import DTYPE_CODES as _DTYPE_CODES
from repro_torch.kernels.build import arrival_counters as _counters
from repro_torch.kernels.build import check as _check
from repro_torch.kernels.build import stream_ptr as _stream_ptr
from repro_torch.kernels.wkv_scan import ref as R
from repro_torch.obs import launch as OBS
from repro_torch.roofline import dispatch_count as DC

HEAD_SIZES = (8, 16, 32, 64)  # the kernel's register tilings of a column
WKV_CHUNK = 64  # steps a block takes of its stream (csrc/wkv_scan.cu)


def chunk_len(l: int, block_l: int = 64) -> int:
    """min(block_l, l), halved until it divides l."""
    bl = min(block_l, l)
    while l % bl:
        bl //= 2
    return bl


def wkv_meta(impl: str, b: int, l: int, h: int, hd: int, block_l: int):
    n_chunks = l // block_l
    return OBS.meta_dense("wkv_scan.wkv", "wkv_scan", impl=impl,
                          grid=(n_chunks,), block_shape=(block_l, hd),
                          tiles_domain=n_chunks, kind="chunked", cells=b * h)


def _zero_state(r):
    b, _, h, hd = r.shape
    return torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)


def wkv_torch(r, k, v, lw, u, s0=None, *, block_l: int = 64, state_out=None):
    """Plain version: (out (B, L, H, hd) in r's dtype, s_L (B, H, hd, hd)
    f32), s_L written into ``state_out`` when given."""
    b, l, h, hd = r.shape
    if s0 is None:
        s0 = _zero_state(r)
    OBS.record_launch(wkv_meta("torch", b, l, h, hd, chunk_len(l, block_l)),
                      (r, k, v, lw, u, s0))
    out, s = R.wkv_ref(r, k, v, lw, u, s0)
    if state_out is not None:
        s = state_out.copy_(s)
    return out.to(r.dtype), s


def _check_kernel_input(r, k, v, lw, u, s0, state_out):
    _check(r.ndim == 4 and k.shape == v.shape == lw.shape == r.shape,
           f"wkv: r, k, v, lw must share one (B, L, H, hd) shape, got "
           f"{[tuple(t.shape) for t in (r, k, v, lw)]}")
    b, l, h, hd = r.shape
    _check(hd in HEAD_SIZES and l >= 1,
           f"wkv: head size {hd} must be one of {HEAD_SIZES} and L = {l} "
           ">= 1")
    _check(r.dtype in _DTYPE_CODES
           and all(t.dtype == r.dtype for t in (k, v, lw)),
           f"wkv: r, k, v, lw must be one dtype, f32 or bf16, got "
           f"{[t.dtype for t in (r, k, v, lw)]}")
    _check(tuple(u.shape) == (h, hd) and u.dtype == torch.float32,
           f"wkv: u must be ({h}, {hd}) f32, got {tuple(u.shape)} {u.dtype}")
    for name, t in (("s0", s0), ("state_out", state_out)):
        _check(tuple(t.shape) == (b, h, hd, hd) and t.dtype == torch.float32,
               f"wkv: {name} must be ({b}, {h}, {hd}, {hd}) f32, got "
               f"{tuple(t.shape)} {t.dtype}")
    tensors = (r, k, v, lw, u, s0, state_out)
    _check(all(t.is_contiguous() and t.device == r.device for t in tensors),
           "wkv: every tensor must be contiguous on one device")
    _check(all(t.data_ptr() % 16 == 0 for t in (r, k, v, lw)),
           "wkv: r, k, v, lw must start on 16-byte boundaries (the kernel "
           "stages them by cp.async)")
    _check(not any(t.requires_grad for t in tensors),
           "wkv: the kernel has no backward; differentiate through the "
           "plain version (impl='torch')")


def wkv(r, k, v, lw, u, s0=None, *, block_l: int = 64, state_out=None):
    """r, k, v, lw (B, L, H, hd) f32 or bf16; u (H, hd) f32; s0 (B, H,
    hd, hd) f32 or None (zeros). Returns (out (B, L, H, hd) in r's dtype,
    s_L (B, H, hd, hd) f32), s_L written into ``state_out`` (which may be
    s0) when given."""
    if r.is_meta:
        _check(not any(t is not None and t.requires_grad
                       for t in (r, k, v, lw, u, s0, state_out)),
               "wkv: the kernel has no backward; differentiate through the "
               "plain version (impl='torch')")
        b, l, h, hd = r.shape
        DC.record_region("wkv_scan.wkv", b, l, h, hd)
        if state_out is None:
            state_out = r.new_empty((b, h, hd, hd), dtype=torch.float32)
        return torch.empty_like(r), state_out
    if not r.is_cuda:
        return wkv_torch(r, k, v, lw, u, s0, block_l=block_l,
                         state_out=state_out)
    b, l, h, hd = r.shape
    if s0 is None:
        s0 = _zero_state(r)
    if state_out is None:
        state_out = torch.empty_like(s0)
    _check_kernel_input(r, k, v, lw, u, s0, state_out)
    bl = chunk_len(l, block_l)
    lib = BUILD.load("wkv_scan")
    out = torch.empty_like(r)
    slot = counters = 0  # pointers; a lone chunk needs neither
    if l > WKV_CHUNK:  # kept referenced until the launch is enqueued
        scratch = (torch.empty_like(s0), _counters(r, 1 + b * h))
        slot, counters = (x.data_ptr() for x in scratch)
    OBS.instrumented_launch(
        wkv_meta("cuda", b, l, h, hd, bl), lib.wkv_launch,
        (r, k, v, lw, u, s0), r.data_ptr(), k.data_ptr(), v.data_ptr(),
        lw.data_ptr(), u.data_ptr(), s0.data_ptr(), out.data_ptr(),
        state_out.data_ptr(), slot, counters, b, l, h, hd,
        _DTYPE_CODES[r.dtype], _stream_ptr(r))
    wkv.launches += 1
    return out, state_out


wkv.launches = 0

# every kernel wrapper, by the launch name it records
WRAPPERS = {"wkv_scan.wkv": wkv}
