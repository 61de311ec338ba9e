"""The port's sharding rules and meshes (parallel/sharding.py,
launch/mesh.py) against the reference's (repro/parallel/sharding.py).

The reference's rules read a mesh's ``shape`` and ``axis_names`` and
nothing else, so they are called here with the port's abstract meshes
(stand-ins of a ``jax.sharding.Mesh``) on the reference's
``jax.eval_shape`` params tree; nothing in the JAX package changes. The
rules must agree leaf for leaf for every arch on (16, 16), (2, 16, 16)
and an 8-way "data" mesh; the divisibility fallback and the dry-run's
``auto_opts`` agree with the reference's (the latter in a subprocess: the
reference's dry-run module sets XLA_FLAGS when imported).
"""

import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as JREG
from repro.parallel import sharding as JSH
from repro_torch.configs import registry as REG
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import mesh as MESH
from repro_torch.parallel import sharding as SH

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": MESH.make_production_mesh(),
          "multi": MESH.make_production_mesh(multi_pod=True),
          "data8": MESH.AbstractMesh(("data",), (8,))}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


@lru_cache(maxsize=None)
def _ref_params(arch):
    return JREG.params_specs(JREG.get_config(arch))


def _ref_specs(mesh, params):
    specs = JSH.param_specs_tree(mesh, params)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(str(p.key) for p in path): tuple(spec)
            for path, spec in flat}


def test_meshes():
    assert MESHES["single"].shape == {"data": 16, "model": 16}
    assert MESHES["multi"].shape == {"pod": 2, "data": 16, "model": 16}
    assert (MESHES["single"].size, MESHES["multi"].size) == (256, 512)
    card = MESH.make_card_mesh()
    assert card.axis_names == ("data",) and card.size == 1
    local = MESH.make_local_mesh()
    assert local.axis_names == ("data",)
    assert local.size == max(1, torch.cuda.device_count())
    with pytest.raises(ValueError):
        MESH.AbstractMesh(("data",), (1, 2))


@pytest.mark.parametrize("arch", REG.ARCH_IDS)
def test_param_rules_leaf_for_leaf(arch):
    jparams = _ref_params(arch)
    params = REG.params_specs(REG.get_config(arch))
    shapes = dict(_flat(params))
    assert {k: tuple(v.shape) for k, v in shapes.items()} == {
        k: tuple(v.shape) for k, v in _flat_jax(jparams)}
    for name, mesh in MESHES.items():
        want = _ref_specs(mesh, jparams)
        got = dict(_flat(SH.param_specs_tree(mesh, params)))
        assert set(got) == set(want), name
        for key, spec in want.items():
            padded = spec + (None,) * (shapes[key].ndim - len(spec))
            assert got[key] == padded, (name, key, got[key], padded)


def _flat_jax(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(str(p.key) for p in path), leaf) for path, leaf in flat]


def test_card_mesh_replicates_every_leaf():
    card = MESH.make_card_mesh()
    for arch in REG.ARCH_IDS:
        params = REG.params_specs(REG.get_config(arch))
        specs = SH.param_specs_tree(card, params)
        assert all(SH.shard_factor(s, card) == 1 for _, s in _flat(specs))
        total = sum(t.numel() * t.element_size() for _, t in _flat(params))
        assert SH.per_device_bytes(params, specs, card) == total


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), (7, 13)), (("data", "model"), (32, 48)),
    (("model", None), (48, 5)), ((("pod", "data"), None), (64, 3)),
    ((("pod", "data"), None), (16, 3)), (("pod",), (4,)),
    ((("data", "model"), "pod"), (256, 6)), ((), (5, 5))])
def test_fallback_matches_the_reference(spec, shape):
    for mesh in MESHES.values():
        want = tuple(JSH.fallback(P(*spec), shape, mesh))
        want += (None,) * (len(shape) - len(want))
        assert SH.fallback(spec, shape, mesh) == want


def test_dp_axes_and_axis_size():
    for mesh in MESHES.values():
        assert SH.dp_axes(mesh) == JSH.dp_axes(mesh)
        for axis in (None, "data", "model", "pod", ("pod", "data")):
            assert SH._axis_size(mesh, axis) == JSH._axis_size(mesh, axis)


def test_per_device_bytes():
    mesh = MESHES["single"]
    tree = {"layers": {"wq": torch.empty((2, 64, 32), dtype=torch.bfloat16,
                                         device="meta")},
            "final_norm": torch.empty((64,), device="meta")}
    specs = SH.param_specs_tree(mesh, tree)
    assert specs["layers"]["wq"] == (None, "data", "model")
    assert specs["final_norm"] == (None,)
    assert SH.per_device_bytes(tree, specs, mesh) == \
        2 * 64 * 32 * 2 // 256 + 64 * 4
    assert SH.per_device_bytes(tree, specs, mesh, dtype_bytes=4) == \
        2 * 64 * 32 * 4 // 256 + 64 * 4


def test_batch_cache_token_rules():
    single, multi = MESHES["single"], MESHES["multi"]
    cfg = REG.get_config("jamba-1.5-large-398b")
    shape = REG.get_shape("decode_32k")
    cache = REG.cache_specs(cfg, shape)
    specs = dict(_flat(SH.cache_shardings(single, cache)))
    for key, leaf in _flat(cache):
        if leaf.ndim == 5:  # KV: batch over dp, sequence over model
            assert specs[key] == (None, ("data",), "model", None, None)
    long = REG.cache_specs(cfg, REG.get_shape("long_500k"))
    for key, spec in _flat(SH.cache_shardings(multi, long)):
        if len(spec) == 5:  # B = 1: the sequence over every axis
            assert spec == (None, None, ("pod", "data", "model"), None, None)
    batch = REG.batch_specs(cfg, REG.get_shape("train_4k"))
    assert SH.batch_shardings(multi, batch)["tokens"] == \
        (("pod", "data"), None)
    tok = REG.decode_specs(cfg, shape)
    assert SH.token_shardings(single, tok) == {"tokens": (("data",), None),
                                               "pos": ()}


_AUTO = """
import json
from repro.configs import registry as JREG
from repro.launch import dryrun as JD
from repro_torch.launch import mesh as MESH
meshes = {"single": MESH.make_production_mesh(),
          "multi": MESH.make_production_mesh(multi_pod=True)}
print(json.dumps({f"{a} {s} {m}": list(JD.auto_opts(
    JREG.get_config(a), mesh, JREG.get_shape(s)))
    for a in JREG.ARCH_IDS for s in JREG.SHAPES
    for m, mesh in meshes.items()}))
"""


def test_auto_opts_match_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _AUTO], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    want = json.loads(run.stdout.strip().splitlines()[-1])
    for key, opts in want.items():
        arch, shape, mesh = key.split()
        got = DRY.auto_opts(REG.get_config(arch), DRY.make_mesh(mesh),
                            REG.get_shape(shape))
        assert list(got) == opts, key
