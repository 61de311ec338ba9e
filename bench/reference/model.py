"""The plain reference of a served model: float32, TF32 off.

The embedding, the layers of the configuration's family (its own file,
``bench/reference/<family>.py``), a final RMS norm and an untied head, in
plain ``torch`` operations, with the building blocks the families share
(RMS norm, RoPE, causal attention within segments). It imports nothing of
the program: it takes the weights the benchmark drew
(``bench/core/weights.py``), each layer's read in float32 only while that
layer runs, so a model far larger than the card in float32 is computed
layer by layer.

``Precision("fp8")`` is the control: every matrix product's two operands
are rounded to float8 e4m3 (one scale a tensor, its largest magnitude at
448) before the float32 product, the nearest precision below the bfloat16
that the configurations state.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def strict_f32():
    """float32 products on the card are float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """f32: products in float32. fp8: each operand of a product rounded to
    float8 e4m3 first (the gradient passes the rounding straight through)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}: f32 or fp8")
        self.kind = kind

    def q(self, x):
        if self.kind == "f32":
            return x
        with torch.no_grad():
            scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
            r = (x / scale).to(torch.float8_e4m3fn).float().mul_(scale)
        return x + (r - x).detach() if x.requires_grad else r

    def mm(self, a, b):
        """A product of two activations."""
        return self.q(a) @ self.q(b)

    def mm_w(self, a, w):
        """A product with a weight that ``weights`` already rounded."""
        return self.q(a) @ w

    def weights(self, w: dict) -> dict:
        """A layer's (nested) leaves with its matrices rounded once (norms
        kept)."""
        return {k: self.weights(t) if isinstance(t, dict) else
                t if t.dim() < 2 else self.q(t) for k, t in w.items()}


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """Half-split rotary embedding. x (S, H, D) float32; pos (S,)."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, seg, prec: Precision):
    """Causal attention within each segment. q (S, H, D), k and v (S, Hkv,
    D), seg (S,) the document of each row; one key/value head's group of
    query heads at a time."""
    s, h, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    i = torch.arange(s, device=q.device)
    allowed = (i[None, :] <= i[:, None]) & (seg[None, :] == seg[:, None])
    outs = []
    for j in range(hkv):
        qj = q[:, j * g:(j + 1) * g].transpose(0, 1)        # (g, S, D)
        kj, vj = k[:, j], v[:, j]                            # (S, D)
        sc = prec.mm(qj, kj.T) / math.sqrt(d)
        p = torch.softmax(sc.masked_fill(~allowed, float("-inf")), dim=-1)
        outs.append(prec.mm(p, vj).transpose(0, 1))          # (S, g, D)
    return torch.cat(outs, dim=1)


def layer_group(m: dict, i: int) -> tuple:
    """(group, index) of layer ``i`` in the port's tree: the layer pattern's
    ``l<k>`` groups, each stacked over the pattern's repeats."""
    p = len(m.get("layer_pattern") or ("attn",))
    return f"l{i % p}", i // p


def layer_tree(params: dict, m: dict, i: int) -> dict:
    """Layer ``i``'s leaves of a tree laid out as the port's, in float32,
    nested as the tree nests them."""
    group, j = layer_group(m, i)

    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[j].float()

    return cut(params["layers"][group])


@torch.no_grad()
def served_logits(params: dict, m: dict, seqs, rows, prec: Precision,
                  device, cols: int = 32768):
    """Logits of a greedy server's choices. ``seqs``: token arrays, each a
    prompt followed by the tokens served for it; ``rows``: for each, the
    positions whose next token was served. Returns one float32 (len(rows),
    vocab) tensor a sequence, every layer's weights read once in float32."""
    from bench.core import spec

    strict_f32()
    fam = spec.family(m)
    xs = [params["embed"][torch.as_tensor(s, device=device)].float()
          for s in seqs]
    for l in range(m["n_layers"]):
        w = prec.weights(layer_tree(params, m, l))
        for i, s in enumerate(seqs):
            n = len(s)
            pos = torch.arange(n, device=device)
            xs[i] = fam.layer(w, xs[i], pos, torch.zeros_like(pos), m, prec)
        del w
    head = params["lm_head"]
    fn = params["final_norm"].float()
    hsel = [rms_norm(x[torch.as_tensor(r, device=device)], fn,
                     m["norm_eps"]) for x, r in zip(xs, rows)]
    del xs
    parts = [[] for _ in hsel]
    for c in range(0, head.shape[1], cols):
        wc = prec.weights({"w": head[:, c:c + cols].float()})["w"]
        for i, hs in enumerate(hsel):
            parts[i].append(prec.mm_w(hs, wc))
    return [torch.cat(p, dim=1) for p in parts]
