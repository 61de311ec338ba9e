"""The plain reference of the ``dense`` family: a GQA transformer of
pre-norm residual layers (RMS norm, attention with half-split RoPE over
grouped key/value heads, then a swiglu or squared-ReLU MLP), as the port
lays out its parameters, written from the architecture's equations.

A family's file gives the harness what depends on the architecture, found
by the configuration's ``family``:

  leaf_specs(m)          (path, shape, scale) of every leaf in draw order,
                         in the port's tree; scale 0 marks a norm scale;
  layer(w, x, pos, seg, m, prec)
                         one layer over a sequence, ``w`` the layer's
                         subtree of float32 leaves;
  decays(path)           whether AdamW decays the leaf;
  matmul_params(m)       the parameters a token's matrix products use;
  cache_bytes_per_token(m, cache_elt)
                         the decode cache's bytes a token, all layers;
  attn_layers(m)         the layers that run attention.
"""

from __future__ import annotations

import math

import torch

from bench.reference import model as R


def leaf_specs(m: dict):
    """Every leaf stacked on a leading layer axis under ``layers/l0``."""
    d, n, f = m["d_model"], m["n_layers"], m["d_ff"]
    h, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    v = m["vocab_size"]
    mlp = [("wi", (n, d, f), d)]
    if m["mlp_activation"] == "swiglu":
        mlp.append(("wg", (n, d, f), d))
    mlp.append(("wo", (n, f, d), f))
    specs = [(("embed",), (v, d), 0.02),
             (("layers", "l0", "norm1"), (n, d), 0.0),
             (("layers", "l0", "norm2"), (n, d), 0.0)]
    for name, shape, fan in (("wq", (n, d, h * hd), d),
                             ("wk", (n, d, hkv * hd), d),
                             ("wv", (n, d, hkv * hd), d),
                             ("wo", (n, h * hd, d), h * hd)):
        specs.append((("layers", "l0", "mixer", name), shape,
                      1 / math.sqrt(fan)))
    for name, shape, fan in mlp:
        specs.append((("layers", "l0", "ffn", name), shape,
                      1 / math.sqrt(fan)))
    specs += [(("final_norm",), (d,), 0.0),
              (("lm_head",), (d, v), 1 / math.sqrt(d))]
    return specs


def layer(w: dict, x, pos, seg, m: dict, prec: R.Precision):
    """One layer. w: {"norm1", "norm2", "mixer": {wq, wk, wv, wo},
    "ffn": {wi, [wg], wo}}, its matrices passed through ``prec.weights``."""
    s = x.shape[0]
    h, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    at, ff = w["mixer"], w["ffn"]
    a = R.rms_norm(x, w["norm1"], m["norm_eps"])
    q = R.rope(prec.mm_w(a, at["wq"]).reshape(s, h, hd), pos,
               m["rope_theta"])
    k = R.rope(prec.mm_w(a, at["wk"]).reshape(s, hkv, hd), pos,
               m["rope_theta"])
    v = prec.mm_w(a, at["wv"]).reshape(s, hkv, hd)
    x = x + prec.mm_w(R.attention(q, k, v, seg, prec).reshape(s, h * hd),
                      at["wo"])
    b = R.rms_norm(x, w["norm2"], m["norm_eps"])
    if m["mlp_activation"] == "swiglu":
        gate = prec.mm_w(b, ff["wg"])
        hid = gate * torch.sigmoid(gate) * prec.mm_w(b, ff["wi"])
    elif m["mlp_activation"] == "relu2":
        hid = torch.relu(prec.mm_w(b, ff["wi"])) ** 2
    else:
        raise ValueError(f"mlp_activation {m['mlp_activation']!r}")
    return x + prec.mm_w(hid, ff["wo"])


def decays(path: tuple) -> bool:
    """Weight decay on the matrices, not on the norm scales."""
    return not path[-1].startswith("norm") and path[-1] != "final_norm"


def matmul_params(m: dict) -> int:
    """Every layer's matrices and the head (the embedding is a lookup, the
    norms scale)."""
    return sum(math.prod(shape) for path, shape, scale in leaf_specs(m)
               if scale and path != ("embed",))


def cache_bytes_per_token(m: dict, cache_elt: int) -> int:
    """K and V of every layer."""
    return m["n_layers"] * 2 * m["n_kv_heads"] * m["head_dim"] * cache_elt


def attn_layers(m: dict) -> int:
    return m["n_layers"]
