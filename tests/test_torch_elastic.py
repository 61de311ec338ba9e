"""The port's elastic training: re-planning, stragglers, the heartbeat loop,
asynchronous checkpoints, and data parallelism over a real gloo group.

Against the reference: ``replan_mesh`` and ``shard_assignment`` over the
reference test's ranges, ``HeartbeatMonitor.stragglers`` / ``failed`` on
the same beat sequences. Port only: ``run_training(monitor=)`` beats
after each step; ``save_async`` / ``wait``, the manifest's ``extra``,
``restore(step=)`` and the err_state leaves. Over a 2-rank gloo group
(``tests/torch_dp_worker.py``, spawned, meeting through a ``FileStore``
under ``tmp_path``), from the reference's init state carried across: the
plain DP step on each rank's half of a batch equals one process's step on
the whole batch (f32), also where the halves keep 40 and 60 loss tokens;
the compressed DP step equals a one-process emulation that codes each
rank's token-weighted grads with its own error; the ranks end bitwise
equal; a checkpoint one process wrote restores on both ranks at step 4
and trains to step 5. The reference's jitted steps on a (2,) data mesh of
host devices (a process of its own) equal the port's 2-rank plain steps;
its compressed step codes the whole batch's mean with one shared error,
where the port's ranks each keep their own (ROADMAP C). A mesh with a
"model" axis larger than 1, and an MoE arch in a group, are refused.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import oracles as O
import torch_dp_worker as W
from repro.configs import registry as JREG
from repro.resilience import health as JH
from repro.train import fault_tolerance as JFT
from repro.train import optimizer as JOPT
from repro.train import train_step as JTS
from repro_torch.configs import registry as REG
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as MESH
from repro_torch.models import model as MD
from repro_torch.parallel import compression as C
from repro_torch.resilience import health as H
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import data as DATA
from repro_torch.train import fault_tolerance as FT
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

torch.set_num_threads(2)

WORLD = 2
SPAWN_TIMEOUT_S = 240
REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,pod_size", [(16, 256), (8, 256), (1, 256),
                                            (16, 64), (4, 32)])
def test_replan_mesh_matches_reference(model, pod_size):
    for n in list(range(1, 4097)):
        assert FT.replan_mesh(n, model=model, pod_size=pod_size) == \
            JFT.replan_mesh(n, model=model, pod_size=pod_size), n


@pytest.mark.parametrize("n_shards,workers", [
    (64, [0, 1, 2, 5]), (64, [5, 2, 1, 0]), (7, [3]), (3, [9, 4, 1, 0, 2]),
    (1000, list(range(0, 64, 3)))])
def test_shard_assignment_matches_reference(n_shards, workers):
    got = FT.shard_assignment(n_shards, workers)
    assert got == JFT.shard_assignment(n_shards, workers)
    sizes = [len(v) for v in got.values()]
    assert max(sizes) - min(sizes) <= 1
    assert sorted(s for v in got.values() for s in v) == list(range(n_shards))


def _beats(seed: int, n_workers: int, steps: int):
    """(worker, step, now) beats: worker 3 slow, random jitter, a skipped
    step and a repeated beat."""
    rng = np.random.default_rng(seed)
    t = dict.fromkeys(range(n_workers), 0.0)
    out = []
    for step in range(1, steps + 1):
        for w in range(n_workers):
            if w == 1 and step == 3:
                continue  # a worker that skips a beat
            dt = (2.5 if w == 3 else 1.0) * (1 + 0.1 * rng.random())
            t[w] += dt * (2 if w == 1 and step == 4 else 1)
            out.append((w, step, t[w]))
            if w == 2 and step == 2:
                out.append((w, step, t[w] + 0.5))  # a repeated beat
    return out


@pytest.mark.parametrize("seed,factor", [(0, 1.5), (1, 1.5), (2, 3.0)])
def test_stragglers_match_reference(seed, factor):
    mon = H.HeartbeatMonitor(range(5), timeout_s=10.0,
                             straggler_factor=factor)
    ref = JH.HeartbeatMonitor(range(5), timeout_s=10.0,
                              straggler_factor=factor)
    beats = _beats(seed, 5, 20)
    for i, (w, s, now) in enumerate(beats):
        mon.beat(w, s, now=now)
        ref.beat(w, s, now=now)
        if i % 7 == 0:
            assert mon.stragglers() == ref.stragglers()
            assert mon.failed(now=now + 3) == ref.failed(now=now + 3)
    assert mon.stragglers() == ref.stragglers()
    assert (3 in mon.stragglers()) == (factor < 2.5)
    for w in range(5):
        assert list(mon.health[w].step_times) == \
            list(ref.health[w].step_times)


def test_heartbeat_failure_detection():
    mon = H.HeartbeatMonitor([0, 1, 2], timeout_s=10.0)
    for w in range(3):
        mon.beat(w, 1, now=0.0)
    mon.beat(0, 2, now=8.0)
    mon.beat(1, 2, now=8.0)
    assert mon.failed(now=15.0) == {2}
    assert mon.stragglers() == set()


# ---------------------------------------------------------------------------
# The loop's heartbeat and the checkpoint
# ---------------------------------------------------------------------------


class _Counter:
    def __init__(self, step=0):
        self.step = step


def test_run_training_beats_after_each_step():
    mon = H.HeartbeatMonitor([0, 3])
    seen = []

    def step(state, batch):
        seen.append(mon.health[3].last_step)
        return _Counter(state.step + 1), {"loss": float(batch)}

    state, log = FT.run_training(_Counter(2), step, float, 6, monitor=mon,
                                 worker=3)
    assert state.step == 6 and [m["loss"] for m in log] == [2, 3, 4, 5]
    assert seen == [-1, 3, 4, 5]
    assert mon.health[3].last_step == 6
    assert len(mon.health[3].step_times) == 3
    assert mon.health[0].last_beat is None


def _small_state(compression=True, seed=0):
    cfg = dataclasses.replace(REG.smoke_config("yi-9b"), dtype="bfloat16")
    state = TS.init_state(cfg, OPT.OptConfig(), seed=seed, device="cpu",
                          compression=compression)
    if compression:
        gen = torch.Generator().manual_seed(seed)
        for t in _tensors(state.err_state):
            t.copy_(torch.randn(t.shape, generator=gen))
    return state


def _tensors(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    else:
        yield tree


def _assert_equal(a: TS.TrainState, b: TS.TrainState):
    assert a.step == b.step
    for tree in ("params", "opt_state", "err_state"):
        ta, tb = getattr(a, tree), getattr(b, tree)
        assert (ta is None) == (tb is None), tree
        if ta is not None:
            for x, y in zip(_tensors(ta), _tensors(tb)):
                assert x.dtype == y.dtype and torch.equal(x, y), tree


def test_save_async_snapshots_on_the_callers_thread(tmp_path):
    """The snapshot is taken before save_async returns (an in-place update
    right after does not reach the file); extra lands in the manifest;
    err_state round-trips bitwise; restore(step=) reads an older step."""
    state = _small_state()
    mgr = CKPT.CheckpointManager(str(tmp_path), every=1, keep=3)
    state.step = 3
    want3 = copy.deepcopy(state)
    mgr.save_async(state, 3, extra={"world": 2, "note": "a"})
    for t in _tensors(state.params):
        t.add_(1)  # the next step, updating in place
    state.step = 4
    want4 = copy.deepcopy(state)
    mgr.save_async(state, 4)
    mgr.wait()
    assert CKPT.latest_step(str(tmp_path)) == 4
    got4, man4 = CKPT.restore(str(tmp_path), _small_state(seed=1),
                              device="cpu")
    _assert_equal(got4, want4)
    assert man4["extra"] == {}
    got3, man3 = CKPT.restore(str(tmp_path), _small_state(seed=1),
                              device="cpu", step=3)
    _assert_equal(got3, want3)
    assert man3["step"] == 3 and man3["extra"] == {"world": 2, "note": "a"}
    # a state without err_state restores from the same checkpoint
    plain, _ = CKPT.restore(str(tmp_path), _small_state(compression=False),
                            device="cpu", step=3)
    assert plain.err_state is None
    _assert_equal(plain, dataclasses.replace(want3, err_state=None))
    # and a compressed target needs the err leaves
    CKPT.save(str(tmp_path / "plain"), _small_state(compression=False), 0)
    with pytest.raises(KeyError, match="err_state"):
        CKPT.restore(str(tmp_path / "plain"), _small_state(), device="cpu")


def test_save_sync_keeps_the_last_steps_with_extra(tmp_path):
    state = _small_state(compression=False)
    mgr = CKPT.CheckpointManager(str(tmp_path), every=2, keep=2)
    for s in (2, 4, 6):
        mgr.save_async(state, s, extra={"s": s})
    mgr.save_sync(state, 8, extra={"s": 8})
    mgr.wait()
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) \
        == ["step_00000006", "step_00000008"]
    _, man = CKPT.restore(str(tmp_path), state, device="cpu", step=6)
    assert man["extra"] == {"s": 6}


# ---------------------------------------------------------------------------
# A 2-rank gloo group
# ---------------------------------------------------------------------------


def test_a_model_axis_is_refused():
    for shape, axes in (((1, 2), ("data", "model")),
                        ((2, 2, 4), ("pod", "data", "model"))):
        mesh = MESH.AbstractMesh(axes, shape)
        with pytest.raises(ValueError, match="tensor parallelism"):
            MESH.init_data_group("cpu", mesh, store_path="unused")
    assert MESH.data_parallel_size(MESH.AbstractMesh(
        ("pod", "data", "model"), (2, 3, 1))) == 6
    with pytest.raises(ValueError, match="store_path"):
        MESH.init_data_group("cpu", MESH.AbstractMesh(("data",), (2,)))
    assert not torch.distributed.is_initialized()


# the reference's data-parallel steps, in a process of its own with two
# host devices: the init state's leaves and the batches come from the
# files the fixture writes, its states go to ref_out.npz
REFERENCE_DP = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses, json, sys
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import registry as REG
    from repro.launch.compat import make_mesh
    from repro.parallel import compression as C
    from repro.train import optimizer as OPT
    from repro.train import train_step as TS

    tmp, steps, block = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    opt = OPT.OptConfig(**json.loads(sys.argv[5]))
    cfg = dataclasses.replace(REG.smoke_config("yi-9b"), dtype="float32")
    mesh = make_mesh((2,), ("data",))
    assert mesh.devices.size == 2
    init = np.load(tmp + "/ref_init.npz")
    batches = np.load(tmp + "/ref_batches.npz")
    treedef = jax.tree.structure(
        TS.init_state(jax.random.key(0), cfg, opt, compression=True))
    leaves = [init[f"arr_{i}"] for i in range(treedef.num_leaves)]

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], f"{prefix}.{k}")
        elif tree is not None:
            yield prefix, np.asarray(tree)

    out = {}
    for mode, compressed, masked in (("plain", False, False),
                                     ("plain_masked", False, True),
                                     ("compressed", True, False)):
        state = jax.tree.unflatten(treedef, leaves)
        if not compressed:
            state = dataclasses.replace(state, err_state=None)
        state = jax.device_put(state, NamedSharding(mesh, P()))
        rows = NamedSharding(mesh, P("data"))
        with mesh:
            step = jax.jit(TS.make_train_step(
                cfg, opt, attn_impl="scan", block=block,
                compressed_allreduce=C.make_compressed_allreduce(mesh)
                if compressed else None))
            losses = []
            for s in range(steps):
                keys = ["tokens", "labels"] + (["mask"] if masked else [])
                batch = {k: jax.device_put(batches[f"{s}|{k}"], rows)
                         for k in keys}
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
        out[f"{mode}|losses"] = np.array(losses)
        for tree in ("params", "opt_state", "err_state"):
            out.update(flat(getattr(state, tree), f"{mode}|{tree}"))
    np.savez(tmp + "/ref_out.npz", **out)
    print("REFERENCE_DP_OK")
""")


def _reference_init(cfg, opt, tmp):
    """The reference's compressed init state (float32 smoke yi-9b), its
    leaves written for the reference's process; returns the port's copy."""
    jcfg = dataclasses.replace(JREG.smoke_config("yi-9b"), dtype="float32")
    jopt = JOPT.OptConfig(**dataclasses.asdict(opt))
    jstate = jax.tree.map(np.asarray, JTS.init_state(
        jax.random.key(0), jcfg, jopt, compression=True))
    np.savez(tmp / "ref_init.npz", *jax.tree.leaves(jstate))
    init = TS.state_from_jax(jstate, cfg, device="cpu")
    torch.save(init, tmp / "init.pt")
    return init


def _start_reference(ds, opt, tmp):
    """Write the masked whole batches and start the reference's run."""
    batches = {}
    for s in range(W.STEPS):
        for k, v in W.whole_batch(ds, s, masked=True).items():
            batches[f"{s}|{k}"] = v.numpy()
    np.savez(tmp / "ref_batches.npz", **batches)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE_DP, str(REPO / "src"), str(tmp),
         str(W.STEPS), str(W.BLOCK), json.dumps(dataclasses.asdict(opt))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(REPO))


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Spawn the 2 ranks and the reference's 2-device run once; returns
    {"ranks": {rank: outputs}, "saved": the checkpoint's state, "init":
    the DP runs' init state, "reference": the reference's states}."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg, opt, ds = W.setup()
    init = _reference_init(cfg, opt, tmp)
    ref = _start_reference(ds, opt, tmp)
    try:
        saved = TS.init_state(cfg, opt, seed=3, device="cpu")
        saved.step = 4
        CKPT.save(str(tmp / "ckpt"), saved, 4,
                  extra={"saved_by": "one process"})
        ctx = mp.start_processes(
            W.run, args=(WORLD, str(tmp / "store"), str(tmp),
                         str(tmp / "ckpt")),
            nprocs=WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks did not end in {SPAWN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
        out, err = ref.communicate(
            timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "REFERENCE_DP_OK" in out, out + "\n" + err[-3000:]
    outs = {r: torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)}
    with np.load(tmp / "ref_out.npz") as f:
        reference = dict(f)
    return {"ranks": outs, "saved": saved, "init": init,
            "reference": reference}


def _close(a, b, **tol):
    for x, y in zip(_tensors(a), _tensors(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **tol)


def _bitwise(a, b):
    pairs = list(zip(_tensors(a), _tensors(b)))
    assert pairs
    for x, y in pairs:
        assert x.dtype == y.dtype and torch.equal(x, y)


def _flat(tree, prefix):
    """{dotted key: numpy} of a port tree, as the reference's run keys it."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}.{k}"))
        return out
    return {prefix: tree.detach().numpy()}


def _whole_batch_run(init, compressed, masked, scales=None):
    """STEPS of the port's step on the whole batch in this process, from
    ``init``; compressed: through the hook over one rank (one error),
    noting each leaf's last scale into ``scales``."""
    torch.set_num_threads(W.THREADS)
    try:
        cfg, opt, ds = W.setup()
        state = copy.deepcopy(init)
        hook = None
        if compressed:
            hook = W.noting_scales(C.make_compressed_allreduce(), scales)
        else:
            state.err_state = None
        step = TS.make_train_step(cfg, opt, attn_impl="torch",
                                  block=W.BLOCK, compressed_allreduce=hook)
        state, log = FT.run_training(
            state, step, lambda s: W.whole_batch(ds, s, masked), W.STEPS)
        return state, [m["loss"] for m in log]
    finally:
        torch.set_num_threads(2)


def _per_rank_emulation(init, masked):
    """The compressed DP step emulated in this process: each rank's
    half-batch grads, weighted by its share of the loss tokens, coded with
    that rank's own error, their dequantized values averaged. Returns
    (state, losses, each rank's error)."""
    torch.set_num_threads(W.THREADS)
    try:
        cfg, opt, ds = W.setup()
        state = copy.deepcopy(init)
        errs = [copy.deepcopy(init.err_state) for _ in range(WORLD)]
        losses = []
        for s in range(W.STEPS):
            halves = [W.shard(W.whole_batch(ds, s, masked), r, WORLD)
                      for r in range(WORLD)]
            tokens = [float(h["mask"].sum()) if masked
                      else float(h["labels"].numel()) for h in halves]
            means, loss = None, 0.0
            for r, half in enumerate(halves):
                w = max(tokens[r], 1.0) * WORLD / max(sum(tokens), 1.0)
                views = TS.trainable(state.params)
                l, _ = MD.loss_fn(views, cfg, half, attn_impl="torch",
                                  block=W.BLOCK)
                l.backward()
                grads = TS._map(lambda v: v.grad * w, views)
                mean, _ = C.compressed_psum(grads, errs[r])
                loss += w * float(l.detach()) / WORLD
                means = mean if means is None else TS._map(
                    torch.Tensor.add_, means, mean)
            means = TS._map(lambda g: g.div_(float(WORLD)), means)
            OPT.apply_updates(opt, TS.trainable(state.params), means,
                              state.opt_state, state.step)
            state.step += 1
            losses.append(loss)
        return state, losses, errs
    finally:
        torch.set_num_threads(2)


# AdamW divides each update by sqrt(v) + eps: where a grad nearly cancels
# (to within f32 noise of zero), two sum orders of the same grad move that
# element's update by up to a step of lr. Two runs that sum in other orders
# hold every AdamW moment at the f32 policy, and every param but at most
# this share of a leaf, each of those within one lr a step
ADAM_NOISE_SHARE = 1e-4


def _close_params(got: dict, want: dict, opt):
    for k, x in got.items():
        off = ~np.isclose(x, want[k], atol=2e-5, rtol=2e-4)
        assert off.mean() <= ADAM_NOISE_SHARE, (k, int(off.sum()))
        assert np.all(np.abs(x - want[k])[off] <= W.STEPS * opt.lr), k


def _assert_dp_equals_whole_batch(dp_run, mode, masked):
    outs = dp_run["ranks"]
    state, losses = _whole_batch_run(dp_run["init"], False, masked)
    for r in range(WORLD):
        got = outs[r][mode]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        if masked:
            _close_params(_flat(got["params"], ""), _flat(state.params, ""),
                          W.setup()[1])
        else:
            _close(got["params"], state.params, atol=2e-5, rtol=2e-4)
        _close(got["opt_state"], state.opt_state, atol=1e-6, rtol=2e-3)


def test_plain_dp_step_equals_one_process_on_the_whole_batch(dp_run):
    assert all(dp_run["ranks"][r]["mesh"] == {"data": WORLD}
               for r in range(WORLD))
    _assert_dp_equals_whole_batch(dp_run, "plain", masked=False)


def test_plain_dp_step_weighs_each_rank_by_its_loss_tokens(dp_run):
    """The ranks' halves keep 40 and 60 loss tokens: the DP step still
    equals one process's step on the whole masked batch (moments at the
    f32 policy, params but ADAM_NOISE_SHARE of a leaf)."""
    _assert_dp_equals_whole_batch(dp_run, "plain_masked", masked=True)


def _assert_dp_equals_per_rank_emulation(dp_run, mode, masked):
    outs = dp_run["ranks"]
    state, losses, errs = _per_rank_emulation(dp_run["init"], masked)
    for r in range(WORLD):
        got = outs[r][mode]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        _close(got["params"], state.params, atol=2e-5, rtol=2e-4)
        _close(got["err_state"], errs[r], atol=1e-6, rtol=1e-4)
    # each rank keeps its own error: they differ
    assert not all(torch.equal(a, b) for a, b in zip(
        _tensors(outs[0][mode]["err_state"]),
        _tensors(outs[1][mode]["err_state"])))


def test_compressed_dp_step_equals_the_per_rank_emulation(dp_run):
    _assert_dp_equals_per_rank_emulation(dp_run, "compressed", masked=False)


def test_compressed_dp_step_with_uneven_masks_weighs_each_rank(dp_run):
    _assert_dp_equals_per_rank_emulation(dp_run, "compressed_masked",
                                         masked=True)


@pytest.mark.parametrize("mode", ["plain", "plain_masked"])
def test_reference_two_devices_equal_the_ports_two_ranks(dp_run, mode):
    """The reference's jitted step on a (2,) data mesh, the batch's rows
    over it, and the port's 2-rank gloo step from the same carried-across
    state: losses and AdamW moments at the f32 policy, params but
    ADAM_NOISE_SHARE of a leaf (the masked batch's halves weigh 40 and 60
    loss tokens)."""
    ref = dp_run["reference"]
    for r in range(WORLD):
        got = dp_run["ranks"][r][mode]
        np.testing.assert_allclose(got["losses"], ref[f"{mode}|losses"],
                                   rtol=1e-5)
        mine = {tree: _flat(got[tree], f"{mode}|{tree}")
                for tree in ("params", "opt_state")}
        for tree, flat in mine.items():
            assert flat.keys() == {k for k in ref
                                   if k.startswith(f"{mode}|{tree}.")}
        _close_params(mine["params"], ref, W.setup()[1])
        for k, x in mine["opt_state"].items():
            np.testing.assert_allclose(x, ref[k], atol=1e-6, rtol=2e-3,
                                       err_msg=k)


# as tests/test_torch_compression.py: the f32 grad policy's absolute part
# taken relative to a leaf's largest code target (127 scales), and the
# share of a leaf's elements whose code may round the other way
ERR_ATOL = O.tol("attn_grad")["atol"] * 127.0
FLIP_SHARE = 1e-2


def test_reference_two_devices_code_the_whole_batch_mean_with_one_error(
        dp_run):
    """The reference's reading of its compressed all-reduce on a (2,) data
    mesh: the hook's in_specs are P(), so the partitioner first reduces
    the grads to the whole batch's mean and every device codes that mean
    with one shared error. Its state matches the port's compressed step
    on the whole batch in one process (one error; codes that round the
    other way, at most FLIP_SHARE of a leaf, aside). The port's 2-rank
    step codes each rank's own grads with its own error instead (ROADMAP
    C), so most of each rank's error differs from the reference's."""
    ref = dp_run["reference"]
    scales = {}
    state, losses = _whole_batch_run(dp_run["init"], True, False, scales)
    np.testing.assert_allclose(ref["compressed|losses"], losses, rtol=1e-5)
    errs = _flat(state.err_state, "compressed|err_state")
    params = _flat(state.params, "compressed|params")
    ranks = [_flat(dp_run["ranks"][r]["compressed"]["err_state"],
                   "compressed|err_state") for r in range(WORLD)]
    assert errs.keys() == {k for k in ref
                           if k.startswith("compressed|err_state.")}
    for k, got in errs.items():
        scale = float(scales[k[len("compressed|err_state."):]])
        off = np.abs(got - ref[k]) / scale > ERR_ATOL
        assert off.mean() <= FLIP_SHARE, (k, int(off.sum()))
        pk = "compressed|params" + k[len("compressed|err_state"):]
        _close_params({pk: params[pk][~off]}, {pk: ref[pk][~off]},
                      W.setup()[1])
        for r in range(WORLD):
            # over the elements that carry an error (an embedding row no
            # token of the batch reads has none)
            live = (ranks[r][k] != 0) | (ref[k] != 0)
            rank_off = np.abs(ranks[r][k] - ref[k])[live] / scale > ERR_ATOL
            assert rank_off.mean() > 0.5, (k, r, rank_off.mean())


@pytest.mark.parametrize("mode", ["plain", "compressed", "resumed",
                                  "plain_masked", "compressed_masked"])
def test_ranks_end_bitwise_equal(dp_run, mode):
    outs = dp_run["ranks"]
    _bitwise(outs[0][mode]["params"], outs[1][mode]["params"])
    if mode != "resumed":
        _bitwise(outs[0][mode]["opt_state"], outs[1][mode]["opt_state"])


def test_one_process_checkpoint_restores_on_every_rank(dp_run):
    saved = dp_run["saved"]
    for r in range(WORLD):
        out = dp_run["ranks"][r]
        assert out["restored"]["step"] == 4
        assert out["restored"]["manifest"]["extra"] == {
            "saved_by": "one process"}
        _bitwise(out["restored"]["params"], saved.params)
        assert out["resumed"]["step"] == 5
        assert np.isfinite(out["resumed"]["loss"])


def test_a_group_refuses_moe(monkeypatch):
    """An MoE layer's load-balance loss and expert capacity are taken over
    the batch one rank holds, so a step in a group of more than one rank
    refuses an MoE arch (before any collective)."""
    cfg = REG.smoke_config("granite-moe-3b-a800m")
    assert cfg.n_experts
    opt = OPT.OptConfig()
    state = TS.init_state(cfg, opt, device="cpu")
    batch = DATA.SyntheticLM(cfg, ShapeConfig("t", 32, 2, "train"),
                             device="cpu").batch(0)
    step = TS.make_train_step(cfg, opt, attn_impl="torch", block=W.BLOCK)
    monkeypatch.setattr(TS, "_data_world", lambda: WORLD)
    with pytest.raises(ValueError, match="MoE layers"):
        step(state, batch)
