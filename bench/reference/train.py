"""The plain reference of a training step: next-token cross entropy and
AdamW with global-norm clipping and a warmup-cosine learning rate, in
float32 with TF32 off.

The float32 parameters and AdamW's two moments stay on the card (16 bytes a
parameter); activations do not. Each step runs the layers forward keeping
only each layer's input, then walks them backward, recomputing one layer at
a time. The clip needs the whole gradient's norm before any update, so the
backward walk runs twice: the first sums the squares, the second updates
each leaf as soon as its gradient is whole.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from bench.core import spec
from bench.core import weights as W
from bench.reference import model as R


def lr_at(o: dict, step: int) -> float:
    """The learning rate of 0-based ``step``: linear warmup over
    ``warmup_steps``, then cosine decay to ``min_lr_frac`` of ``lr`` at
    ``total_steps``."""
    s = step + 1
    if s < o["warmup_steps"]:
        return o["lr"] * s / o["warmup_steps"]
    t = (s - o["warmup_steps"]) / max(o["total_steps"] - o["warmup_steps"], 1)
    t = min(max(t, 0.0), 1.0)
    return o["lr"] * (o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5
                      * (1 + math.cos(math.pi * t)))


def _walk(tree: dict, prefix: tuple):
    for k, t in tree.items():
        if isinstance(t, dict):
            yield from _walk(t, prefix + (k,))
        else:
            yield prefix + (k,), t


def _layer_leaves(params: dict, m: dict, i: int
                  ) -> Tuple[Dict[tuple, torch.Tensor], dict, int]:
    """Layer ``i``'s parameters as leaves that autograd differentiates,
    sharing storage with the stacked float32 tensors: ({path: leaf}, the
    same leaves nested as the family's layer takes them, the index on the
    stacked axis)."""
    group, j = R.layer_group(m, i)
    flat, nested = {}, {}
    base = ("layers", group)
    for path, t in _walk(params["layers"][group], base):
        flat[path] = t[j].detach().requires_grad_()
        W.put(nested, path[len(base):], flat[path])
    return flat, nested, j


def cross_entropy(logits, labels, mask):
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    return ((lse - ll) * mask).sum() / mask.sum().clamp(min=1.0)


def _grads(params: dict, m: dict, batch: dict, prec: R.Precision
           ) -> Iterator[Tuple[tuple, int, torch.Tensor]]:
    """(path, index on the stacked axis or -1, float32 gradient) of every
    leaf, the head first,
    then the layers from the last, then the embedding; the loss is sent
    first as (("loss",), -1, loss)."""
    fam = spec.family(m)
    tok, pos, seg = batch["tokens"], batch["positions"], batch["segments"]
    xs = []
    with torch.no_grad():
        x = params["embed"][tok]
        for l in range(m["n_layers"]):
            xs.append(x)
            x = fam.layer(prec.weights(R.layer_tree(params, m, l)), x, pos,
                          seg, m, prec)
    x = x.detach().requires_grad_()
    fn = params["final_norm"].detach().requires_grad_()
    head = params["lm_head"].detach().requires_grad_()
    h = R.rms_norm(x, fn, m["norm_eps"])
    loss = cross_entropy(prec.mm_w(h, prec.q(head)), batch["labels"],
                         batch["mask"])
    loss.backward()
    yield ("loss",), -1, loss.detach()
    yield ("lm_head",), -1, head.grad
    yield ("final_norm",), -1, fn.grad
    gx = x.grad
    del x, h, loss
    for l in reversed(range(m["n_layers"])):
        xin = xs[l].requires_grad_()
        leaves, nested, j = _layer_leaves(params, m, l)
        out = fam.layer(prec.weights(nested), xin, pos, seg, m, prec)
        out.backward(gx)
        gx = xin.grad
        xs[l] = None
        del out, xin
        for path, t in leaves.items():
            yield path, j, t.grad
    g_embed = torch.zeros_like(params["embed"])
    g_embed.index_add_(0, tok, gx)
    yield ("embed",), -1, g_embed


def _part(t: torch.Tensor, l: int) -> torch.Tensor:
    return t[l] if l >= 0 else t


def train(m: dict, o: dict, seed: int, batches: List[dict], device,
          prec: R.Precision) -> dict:
    """Follow ``len(batches)`` AdamW steps from the seed's weights.
    Returns {"loss": [each step's loss], "grad_norm": {leaf: the first
    step's clipped gradient's norm}, "update_norm": {leaf: the norm of the
    parameters' change over all the steps}}."""
    R.strict_f32()
    fam = spec.family(m)
    params: dict = {}
    for path, t in W.leaves(m, seed, device):
        W.put(params, path, t.float())
    mom = {p: torch.zeros_like(W.get(params, p)) for p, *_ in
           fam.leaf_specs(m)}
    vel = {p: torch.zeros_like(t) for p, t in mom.items()}
    losses, gsq = [], {}
    for step, batch in enumerate(batches):
        total = 0.0
        for path, _, g in _grads(params, m, batch, prec):
            if path != ("loss",):
                total += float(torch.sum(g * g))
        scale = min(1.0, o["grad_clip"] / max(math.sqrt(total), 1e-12))
        lr = lr_at(o, step)
        bc1, bc2 = 1 - o["b1"] ** (step + 1), 1 - o["b2"] ** (step + 1)
        for path, l, g in _grads(params, m, batch, prec):
            if path == ("loss",):
                losses.append(float(g))
                continue
            g = g * scale
            if step == 0:
                gsq[path] = gsq.get(path, 0.0) + float(torch.sum(g * g))
            p = _part(W.get(params, path), l)
            mm, vv = _part(mom[path], l), _part(vel[path], l)
            with torch.no_grad():
                mm.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                vv.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
                u = (mm / bc1) / (torch.sqrt(vv / bc2) + o["eps"])
                if fam.decays(path):
                    u += o["weight_decay"] * p
                p.sub_(lr * u)
            del g, u
    del mom, vel
    upd = {}
    for path, t0 in W.leaves(m, seed, device):
        upd[path] = float(torch.linalg.vector_norm(W.get(params, path)
                                                   - t0.float()))
    return {"loss": losses,
            "grad_norm": {p: math.sqrt(v) for p, v in gsq.items()},
            "update_norm": upd}
