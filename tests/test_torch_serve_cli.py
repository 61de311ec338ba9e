"""The port's serving CLI (``python -m repro_torch.launch.serve``) on the
CPU: the reference's flags plus --device and --step-mode, every request
done, the stats lines printed; the kernel-only modes refused with cuda."""

import pytest
import torch

from repro_torch import device as DEV
from repro_torch.launch import serve as SERVE

ARGS = ["--device", "cpu", "--requests", "5", "--slots", "3",
        "--max-new", "4", "--prompt-len", "10", "--max-len", "48"]


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_serve_cli_on_cpu(step_mode, capsys):
    results, engine = SERVE.main(ARGS + ["--step-mode", step_mode])
    report = engine.report()
    assert sorted(results) == sorted(report) == list(range(5))
    assert all(r["status"] == "done" and r["tokens"] == 4
               for r in report.values())
    out = capsys.readouterr().out
    assert "5/5 requests, 20 tokens" in out
    assert f"step_mode={step_mode}" in out
    assert "prefill[packed]" in out and "decode[auto]" in out
    st = engine.stats
    # the default decode mode: each split round counted as the mode it ran
    split_rounds = st["decode_packed_launches"] + \
        st["decode_lockstep_launches"]
    if step_mode == "fused":
        assert st["fused_rounds"] >= 1
        assert 0 < split_rounds <= st["decode_rounds"]
    else:
        assert st["fused_rounds"] == 0 and st["prefill_launches"] >= 1
        assert split_rounds == st["decode_rounds"] > 0


def test_serve_cli_plain_modes_and_refusals(capsys):
    results, engine = SERVE.main(ARGS + ["--prefill-mode", "sequential",
                                         "--decode-mode", "lockstep"])
    assert all(r["status"] == "done" for r in engine.report().values())
    assert engine.stats["decode_lockstep_launches"] >= 1
    assert "decode[lockstep]" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # not a decode mode
        SERVE.main(ARGS + ["--decode-mode", "fused"])
    # the plain-version modes never run on the kernels' path
    for mode in (["--prefill-mode", "sequential"],
                 ["--decode-mode", "lockstep"]):
        with pytest.raises(SystemExit):
            SERVE.main(mode + ["--requests", "1"])
    assert "pass --device cpu" in capsys.readouterr().err


class _Built(Exception):
    pass


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_serve_cli_any_cuda_device_takes_the_kernels(device, monkeypatch,
                                                     capsys):
    """Every CUDA device string selects the kernels, never the plain
    versions on the card; without a card it raises instead."""
    assert DEV.attn_impl(device) == "cuda"
    assert DEV.attn_impl(torch.device(device)) == "cuda"
    assert DEV.attn_impl("cpu") == "torch"
    for mode in (["--prefill-mode", "sequential"],
                 ["--decode-mode", "lockstep"]):
        with pytest.raises(SystemExit):
            SERVE.main(mode + ["--device", device, "--requests", "1"])
    assert "pass --device cpu" in capsys.readouterr().err

    def engine(params, cfg, **kw):
        raise _Built(kw)

    with monkeypatch.context() as m:
        m.setattr(SERVE.MD, "init_params", lambda cfg, seed, device: None)
        m.setattr(SERVE, "Engine", engine)
        with pytest.raises(_Built) as built:
            SERVE.main(["--device", device, "--requests", "1"])
    kw = built.value.args[0]
    assert kw["prefill_impl"] == kw["decode_impl"] == "cuda"
    assert kw["device"] == device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            SERVE.main(["--device", device, "--requests", "1"])
