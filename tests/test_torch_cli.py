"""The port's command line (``cli/args.py``, ``cli/main.py``,
``core/config.py``) on the CPU:

- its parser has the JAX parser's flags, option strings and defaults, but
  for the one it leaves out (``--compile-cache``, XLA's compilation
  cache);
- the parallel flags take only one device's values outside ``torchrun``,
  and the others raise naming ROADMAP queue 1 item 8; ``--remat`` with the
  TPU's ``--remat-policy mxu`` raises;
- ``--vgg-weights`` and ``--allow-placeholder-vgg`` reach the Config, and a
  perceptual loss without weights raises FileNotFoundError;
- ``ModelTrainer.train`` runs with cuDNN's deterministic mode on and
  restores the prior setting after the run;
- ``main([... "--use-cpu"])`` trains the full-width SpectralTransformer for
  one epoch at 32x32 (tee log under the hyperparameter directory,
  checkpoints, metrics, the probe image ``6_img_.png``), resumes for a
  second, and ``--evaluate`` writes one image a input;
- without CUDA and without ``--use-cpu`` both branches raise
  ``CudaUnavailableError``; ``python -m underwater_image_restoration_torch.cli``
  runs;
- ``--profile-dir``'s chrome trace, and the W&B sink falling back to JSONL
  where ``wandb`` does not import.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from underwater_image_restoration_tpu.cli.args import (
    argument_parser as jax_argument_parser,
)
from underwater_image_restoration_torch import _device
from underwater_image_restoration_torch.cli.args import argument_parser
from underwater_image_restoration_torch.cli.main import main
from underwater_image_restoration_torch.core.config import from_namespace
from underwater_image_restoration_torch.data import synthetic_pair_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    where torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LEFT_OUT = {"compile_cache"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax_but_the_tpu_flags():
    got, want = _actions(argument_parser()), _actions(jax_argument_parser())
    assert LEFT_OUT <= set(want) and not LEFT_OUT & set(got)
    assert got == {k: v for k, v in want.items() if k not in LEFT_OUT}
    ns = argument_parser().parse_args(["--use-wandb", "--no-pallas"])
    assert ns.use_wandb is False  # the reference's store_false quirk
    cfg = from_namespace(ns)
    assert cfg.use_kernels is False and cfg.use_wandb is False
    assert from_namespace(argument_parser().parse_args([])).use_kernels


@pytest.mark.parametrize("argv,match", [
    (["--mesh-data", "2"], "queue 1, item 8"),
    (["--mesh-data", "8"], "queue 1, item 8"),
    (["--mesh-context", "2"], "queue 1, item 8"),
    (["--mesh-context", "16", "--image-size", "16"], "too few rows a rank"),
    (["--shard-params", "data"], "queue 1, item 8"),
    (["--shard-params", "context"], "queue 1, item 8"),
    (["--remat", "--remat-policy", "mxu"], "remat")])
def test_refused_values_raise(argv, match, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=match):
        main(["--use-cpu"] + argv)
    assert not os.path.exists(tmp_path / "logs")


def _data(root):
    """7 train pairs (``6_img_.png`` is the trainer's probe), 3 test."""
    for split, n, seed in (("train", 7, 0), ("test", 3, 1)):
        raw, ref = synthetic_pair_batch(n, 40, seed=seed)
        for sub, arr in (("a", raw), ("b", ref)):
            d = root / "data" / split / sub
            d.mkdir(parents=True)
            for i, img in enumerate(arr):
                Image.fromarray(img).save(d / f"{i}_img_.png")
    return ["--train-raw", "data/train/a", "--train-ref", "data/train/b",
            "--test-raw", "data/test/a", "--test-ref", "data/test/b"]


def test_main_trains_resumes_and_evaluates_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    dirs = _data(tmp_path)
    common = ["--use-cpu", "--image-size", "32", "--train-batch-size", "4",
              "--test-batch-size", "2", "--use-wandb", "--lossf",
              "L1withColor", "--compute-dtype", "float32", "-j", "2",
              "--watch-freq", "3"]
    main(common + dirs + ["--max-epoch", "1"])
    logs = tmp_path / ("logs/arch-SpectralTransformer/optimizer-adam/"
                       "loss-L1withColor/maxEpoch-1/lr-0.0003/batchSize-4/"
                       "perspective-False-rotate-False")
    text = (logs / "log_train.txt").read_text()
    assert "Training completed!" in text and "Validation Loss" in text
    (run,) = list((tmp_path / "checkpoints").iterdir())
    assert os.listdir(run / "best") == ["0"]
    assert sorted(os.listdir(run / "latest" / "0")) == ["metrics.json",
                                                        "state.pt"]
    (probe,) = list((tmp_path / "Images").iterdir())
    assert os.listdir(probe) == ["Epoch 0_ Best True.png"]

    main(common + dirs + ["--max-epoch", "2", "--resume", str(run)])
    assert os.listdir(run / "latest") == ["1"]
    records = [json.loads(line) for line in open(run / "metrics.jsonl")]
    steps = [r["_step"] for r in records if "train/loss" in r]
    assert steps == [0, 1, 2, 3]  # 2 batches (one padded) an epoch
    assert sum("test/PSNR" in r for r in records) == 2
    hist = [r for r in records if "gradients/output.weight" in r]
    assert [r["_step"] for r in hist] == [0, 3]
    assert len(hist[0]["gradients/output.weight"]["counts"]) == 64

    main(["--use-cpu", "--evaluate", "--load-weights", str(run / "best"),
          "--image-in", "data/test/a", "--image-out", "out",
          "--infer-size", "32", "--compute-dtype", "float32"])
    assert sorted(os.listdir(tmp_path / "Images" / "out")) == [
        f"{i}_img_.png.png" for i in range(3)]
    assert len(list((tmp_path / "logs").rglob("log_test.txt"))) == 1


def test_main_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dirs = _data(tmp_path)
    with pytest.raises(_device.CudaUnavailableError):
        main(dirs + ["--image-size", "32", "--max-epoch", "1"])
    with pytest.raises(_device.CudaUnavailableError):
        main(["--evaluate", "--load-weights", "unused", "--image-in",
              "data/test/a"])


def test_module_entry_point_runs():
    res = subprocess.run(
        [sys.executable, "-m", "underwater_image_restoration_torch.cli",
         "--help"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert "--use-cpu" in res.stdout and "--compile-cache" not in res.stdout


def test_profile_trace_and_sinks(tmp_path, monkeypatch, capsys):
    """``--profile-dir``'s ``torch.profiler`` chrome trace, and the W&B sink
    gated on its import (the JSONL sink stays)."""
    from underwater_image_restoration_torch.core.config import Config
    from underwater_image_restoration_torch.obs import (
        ExperimentLogger,
        JsonlSink,
        profile_trace,
    )

    with profile_trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    with profile_trace(""):
        pass
    assert sorted(os.listdir(tmp_path)) == ["prof"]

    monkeypatch.setitem(sys.modules, "wandb", None)
    log = ExperimentLogger(Config(use_wandb=True), save_dir=str(tmp_path))
    assert "wandb disabled" in capsys.readouterr().out
    assert [type(s) for s in log.sinks] == [JsonlSink]
    log.watch_model()
    assert log.watching
    log.log_histograms({"w": (np.array([1, 2]), np.array([0.0, 0.5, 1.0]))},
                       step=3)
    log.finish()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["_step"] == 3 and rec["w"] == {
        "_type": "histogram", "counts": [1, 2], "min": 0.0, "max": 1.0}


def test_vgg_flags_reach_the_loss(tmp_path, monkeypatch):
    ns = argument_parser().parse_args(["--vgg-weights", "vgg16.npz",
                                       "--allow-placeholder-vgg"])
    cfg = from_namespace(ns)
    assert (cfg.vgg_weights, cfg.allow_placeholder_vgg) == ("vgg16.npz",
                                                            True)
    cfg = from_namespace(argument_parser().parse_args([]))
    assert (cfg.vgg_weights, cfg.allow_placeholder_vgg) == ("", False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="VGG16"):
        main(["--use-cpu", "--image-size", "32", "--max-epoch", "1",
              "--lossf", "perceptual", "--vgg-weights", "missing.npz",
              "-j", "1"] + _data(tmp_path))


@pytest.mark.parametrize("before", [False, True])
def test_trainer_runs_cudnn_deterministic(tmp_path, monkeypatch, before):
    """The flag is on for the whole run (read at each epoch's end) and back
    to its prior value afterwards."""
    from underwater_image_restoration_torch.core.config import Config
    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.train import trainer

    monkeypatch.chdir(tmp_path)
    dirs = _data(tmp_path)[1::2]
    monkeypatch.setattr(trainer, "init_model", lambda arch, **k: init_model(
        "SpectralTransformer", device=k["device"], channels=(8, 16, 32, 64),
        num_blocks=(1, 1, 1, 1), num_refinement=1))
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", before)
    seen = []
    trainer.ModelTrainer(*dirs).train(
        Config(use_cpu=True, image_size=32, train_batch_size=4,
               test_batch_size=2, max_epoch=2, use_wandb=False, workers=1,
               watch_freq=0, compute_dtype="float32"),
        on_epoch_end=lambda *a: seen.append(
            torch.backends.cudnn.deterministic))
    assert seen == [True, True]
    assert torch.backends.cudnn.deterministic is before
