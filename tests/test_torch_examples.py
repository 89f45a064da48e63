"""Every example twin of the PyTorch port (``examples/*_torch.py``) runs on
the CPU at its smallest setting and prints its healthy lines; without
``--device cpu`` each one wants the card and, with none here, raises."""
import importlib.util
import os
import re

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("quickstart", "federated_single_dataset", "serve_lm", "train_lm_e2e",
         "cold_service_demo", "cold_fusion_multitask")


@pytest.fixture(autouse=True)
def _one_cpu_thread(monkeypatch):
    """One intra-op thread here and in every process a twin starts: the
    suite runs several workers on a few cores, and torch's BLAS threads
    spin-wait, so a many-threaded run can stall the other workers' tests."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name):
    path = os.path.join(ROOT, "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_reference_example_has_a_twin():
    ref = {f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
           if f.endswith(".py") and not f.endswith("_torch.py")}
    assert ref == set(TWINS)


def test_quickstart(capsys):
    _example("quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("fused 4/4 contributions") == 3
    assert re.search(r"ColD Fusion improved the base model: \d\.\d{3} -> \d\.\d{3}", out)


def test_federated_single_dataset_dry_run(capsys):
    _example("federated_single_dataset").main(["--dry-run", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round 1: fused 2/2, fused-model linear-probe accuracy = " in out
    assert "only weights moved" in out


def test_serve_lm(capsys):
    _example("serve_lm").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "serving gemma3-1b-smoke: 6 layers (5 local / 1 global), d=128" in out
    assert "generated 4x16 tokens" in out and out.count("-> gen=") == 4


def test_train_lm_e2e(capfd):
    assert _example("train_lm_e2e").main(["--device", "cpu", "--steps", "20"]) == 0
    out = capfd.readouterr().out
    assert "-m repro_torch.launch.train --arch gemma3-1b --reduced --steps 200" in out
    assert "[train] gemma3-1b-smoke: ~0.9M params, 20 steps x batch 8 x seq 64" in out
    assert "  step   20: loss=" in out and "[train] done in" in out


@pytest.mark.parametrize("mode", [[], ["--compress"]], ids=["dense", "compress"])
def test_cold_service_demo(mode, tmp_path, capfd):
    demo = _example("cold_service_demo")
    rc = demo.main(["--device", "cpu", "--contributors", "2", "--rounds", "2",
                    "--root", str(tmp_path / "root"), "--timeout", "120", *mode])
    out = capfd.readouterr().out
    assert rc == 0, out
    assert "-> iteration 2, 4 contributions fused" in out
    assert "final base w=0.4500 (expected 0.4500) -> OK" in out
    if mode:
        assert out.count("COMPRESSED") == 4


def test_cold_service_demo_refuses_the_mesh():
    with pytest.raises(SystemExit):
        _example("cold_service_demo").main(["--mesh", "8"])


@pytest.mark.parametrize("name,argv", [("quickstart", []), ("serve_lm", []),
                                       ("federated_single_dataset", ["--dry-run"])])
def test_twins_want_the_card_by_default(name, argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the twin would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(argv)
