"""The port's example drivers run in-process on the CPU, at a few batches.

``examples/torch_serve_readout.py`` (the port of examples/
serve_readout.py) with its hot swap, TMR with an injected upset under
scrubbing, sparse egress, the features path and deadline shedding, and
its flag-combination refusals; ``examples/torch_replay_load.py`` (the
port of examples/replay_load.py) over TCP and UDP, every trigger verified
against the host oracle. Both are handed ``--device cpu``; on the card
they run with no device flag (chip_smoke.py phase 12).
``examples/torch_quickstart.py`` (the port of examples/quickstart.py):
the §5 pipeline on a reduced dataset, every event matching the golden
model; ``examples/torch_serve_lm.py`` (the port of examples/serve_lm.py)
with its defaults (TINY) and at the smoke width of the SSM, MoE and
hybrid families; ``examples/torch_train_lm.py`` (the port of
examples/train_lm.py) for 4 steps, then resumed from its checkpoint.
"""
import ast
import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMALL = ["--device", "cpu", "--chips", "2", "--rate-batches", "3",
         "--batch", "32", "--max-batch", "64"]


@pytest.mark.parametrize("flags", [
    ["--reconfigure-at", "1", "--redundancy", "tmr", "--seu-at", "1",
     "--scrub-interval", "1"],
    ["--sparse", "--seu-rate", "1.0", "--scrub-interval", "1",
     "--scrub-mode", "round_robin"],
    ["--features", "--redundancy", "tmr"],
    ["--deadline-us", "50000", "--overload-policy", "shed"],
], ids=["tmr_seu_scrub", "sparse_poisson_seu", "features", "deadline"])
def test_serve_readout_example_on_cpu(flags, capsys):
    report = _example("torch_serve_readout").main(SMALL + flags)
    out = capsys.readouterr().out
    assert report["device"] == "cpu" and "server online on cpu" in out
    assert report["n_in"] + report["deadline"]["shed"] == 2 * 3 * 32
    assert report["seu_disagreement_total"] == 0 or (
        report["redundancy"] == "tmr")
    if "--seu-at" in flags:
        assert report["scrub"]["detections"] == 1
        assert report["scrub"]["healed_bits"] == 1
        assert "RECONFIGURED chip 0" in out
    if "--sparse" in flags:
        assert report["sparse"] and "on the sparse wire" in out


@pytest.mark.parametrize("flags", [
    ["--seu-at", "1"], ["--scrub-mode", "steered"],
    ["--overload-policy", "shed"], ["--deadline-us", "0"],
    ["--seu-rate", "-1"], ["--scrub-interval", "0"]])
def test_serve_readout_example_refuses_flag_combinations(flags):
    with pytest.raises(SystemExit) as e:
        _example("torch_serve_readout").main(SMALL + flags)
    assert e.value.code == 2


# UDP is paced (the example's default 2,000 events/s a sensor): a
# datagram that arrives while the receive buffer is full is lost, and
# shows as an unanswered batch
@pytest.mark.parametrize("transport,backend,rate", [
    ("tcp", "kernel", "0"), ("udp", "host", "2000")])
def test_replay_load_example_on_cpu(transport, backend, rate, capsys):
    reports = _example("torch_replay_load").main([
        "--device", "cpu", "--sensors", "2", "--batches", "4",
        "--rate", rate, "--transport", transport, "--backend", backend])
    out = capsys.readouterr().out
    per = 7 if transport == "udp" else 16
    assert len(reports) == 2
    for rep in reports:
        assert rep.verified, rep.mismatches
        assert rep.n_events == rep.ack["events_in"] == 4 * per
    assert "all trigger decisions bit-exact vs the host oracle" in out


def test_quickstart_example_on_cpu(capsys):
    v = _example("torch_quickstart").main(["--device", "cpu",
                                           "--events", "20000"])
    out = capsys.readouterr().out
    assert v["device"] == "cpu" and v["n"] > 0 and v["n_match"] == v["n"]
    assert "OK — paper §5 reproduced." in out
    assert "kernel backend, cpu" in out


@pytest.mark.parametrize("flags", [
    [], ["--preset", "smoke", "--arch", "mamba2-130m"],
    ["--preset", "smoke", "--arch", "deepseek-moe-16b"],
    ["--preset", "smoke", "--arch", "zamba2-1.2b"]],
    ids=["tiny", "mamba2-130m", "deepseek-moe-16b", "zamba2-1.2b"])
def test_serve_lm_example_on_cpu(flags, capsys):
    assert _example("torch_serve_lm").main(
        ["--device", "cpu", "--gen", "6"] + flags) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill 16 tokens x 8 reqs")
    assert lines[1].startswith("generated 6 tokens x 8 reqs")
    toks = ast.literal_eval(lines[2].split(":", 1)[1].strip())
    assert len(toks) == 6 and all(isinstance(t, int) for t in toks)


def test_train_lm_example_on_cpu(tmp_path, capsys):
    ck = ["--ckpt-dir", str(tmp_path / "lm")]
    train_lm = _example("torch_train_lm")
    assert train_lm.main(["--device", "cpu", "--steps", "4"] + ck) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step     0  loss") and "tok/s" in out[0]
    assert out[-1].startswith("done in") and "entropy bound 1.3863" in out[-1]
    # the example resumes by default: a longer run picks up at step 4
    assert train_lm.main(["--device", "cpu", "--steps", "5"] + ck) == 0
    assert capsys.readouterr().out.startswith("[resume] restored step 4")
