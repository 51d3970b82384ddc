"""The port's offline evaluation (``eval/metrics.py``, ``eval/uiqm.py``,
``eval/evaluate.py``) against the JAX package's on the CPU.

- the u8 metrics (``to_gray_u8``, ``psnr_gray_u8``, ``drop_lowest``,
  ``psnr_float_pm1``): numpy on both sides, bit-equal;
- ``ssim_pair_u8`` on the CPU: within 1e-6 (the port's SSIM in torch, the
  JAX one in XLA, f32 sums in another order);
- ``compute_uiqm`` (numpy and scipy on both sides): bit-equal for three
  seeds, with and without the cv2 BGR emulation, and with a flat channel;
- ``evaluate_pairs`` on a small SpectralTransformer (channels 8/16/32/64)
  with the same weights on both sides, 3 pairs at 16x16, batch 2 (the last
  padded): the per-image PSNRs within 1e-4 dB, the dumped references
  bit-equal; over its dumped pairs ``dir_ssim_psnr`` (SSIM within 1e-6,
  PSNRs bit-equal: the same PNGs) and ``uiqm_sweep`` (bit-equal);
- ``loss_sanity`` over all 20 names at 64x64: the same names run and
  skipped, each floor within 1e-6;
- the subcommands' parsers: the JAX ones' flags and defaults, plus the
  port's ``--compute-dtype`` and ``--device``;
- a checkpoint directory that the port's CLI writes (NewBigModel-Wavelet,
  two steps on the CPU at 32x32) serves ``infer`` and ``pairs`` at the JAX
  CLI's default arch and frequency branch.
"""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from underwater_image_restoration_tpu.eval import evaluate as jax_eval
from underwater_image_restoration_tpu.eval import metrics as jax_metrics
from underwater_image_restoration_tpu.eval import uiqm as jax_uiqm
from underwater_image_restoration_tpu.losses import perceptual as jax_perc
from underwater_image_restoration_tpu.models.spectral_transformer import (
    SpectralTransformer as JaxSpectralTransformer,
)
from underwater_image_restoration_tpu.tools.convert_checkpoint import (
    convert_spectral_transformer,
    unflatten,
)
from underwater_image_restoration_torch.cli.main import main as cli
from underwater_image_restoration_torch.data import synthetic_pair_batch
from underwater_image_restoration_torch.eval import evaluate, metrics, uiqm
from underwater_image_restoration_torch.losses import perceptual
from underwater_image_restoration_torch.models import init_model

CFG = dict(channels=(8, 16, 32, 64), num_blocks=(1, 1, 1, 1),
           num_refinement=1)
SIZE = 16


def _u8(seed, shape=(24, 20, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _write(d, images, ext=".png"):
    d.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(images):
        Image.fromarray(img).save(d / f"{i:03d}{ext}")
    return str(d)


def test_u8_metrics_are_the_jax_ones():
    a, b = _u8(0), _u8(1)
    ga, gb = metrics.to_gray_u8(a), metrics.to_gray_u8(b)
    assert ga.dtype == np.uint8
    assert np.array_equal(ga, jax_metrics.to_gray_u8(a))
    assert metrics.psnr_gray_u8(ga, gb) == jax_metrics.psnr_gray_u8(ga, gb)
    assert metrics.psnr_gray_u8(ga, ga) == float("inf")
    vals = np.random.default_rng(2).normal(20, 3, 12)
    assert np.array_equal(metrics.drop_lowest(vals),
                          jax_metrics.drop_lowest(vals))
    assert np.array_equal(metrics.drop_lowest(vals, 7),
                          jax_metrics.drop_lowest(vals, 7))
    fa, fb = (x.astype(np.float32) / 127.5 - 1 for x in (a, b))
    assert metrics.psnr_float_pm1(fa, fb) == jax_metrics.psnr_float_pm1(fa,
                                                                         fb)


def test_ssim_pair_u8_matches_jax():
    a, b = _u8(3, (40, 36, 3)), _u8(4, (40, 36, 3))
    for x, y in ((a, b), (a, a), (b, (b // 2 + 40).astype(np.uint8))):
        np.testing.assert_allclose(metrics.ssim_pair_u8(x, y, "cpu"),
                                   jax_metrics.ssim_pair_u8(x, y), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("emulate_cv2", [False, True])
def test_uiqm_is_the_jax_one(seed, emulate_cv2):
    img = _u8(seed, (64, 56, 3))
    if seed == 2:
        img[..., 1] = 0  # a flat channel: the guarded Sobel division
    got = uiqm.compute_uiqm(img, emulate_cv2=emulate_cv2)
    want = jax_uiqm.compute_uiqm(img, emulate_cv2=emulate_cv2)
    assert got == want and all(np.isfinite(got))
    assert uiqm.getUIQM(img) == jax_uiqm.getUIQM(img)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """The two sides' ``evaluate_pairs`` on one small SpectralTransformer
    over 3 pairs at 16x16, batch 2."""
    root = tmp_path_factory.mktemp("pairs")
    raw, ref = synthetic_pair_batch(3, 20, seed=5)
    raw_dir, ref_dir = _write(root / "a", raw), _write(root / "b", ref)
    port = init_model("SpectralTransformer", device="cpu", seed=6, **CFG)
    flat = convert_spectral_transformer(
        {k: v.numpy() for k, v in port.state_dict().items()})
    params = {"params": jax.tree.map(jnp.asarray, unflatten(flat))}
    out = {}
    for side in ("jax", "port"):
        dirs = (str(root / side / "test"), str(root / side / "ref"))
        if side == "jax":
            psnrs = jax_eval.evaluate_pairs(
                JaxSpectralTransformer(**CFG), params, raw_dir, ref_dir,
                *dirs, image_size=SIZE, batch_size=2)
        else:
            psnrs = evaluate.evaluate_pairs(port, raw_dir, ref_dir, *dirs,
                                            image_size=SIZE, batch_size=2)
        out[side] = (psnrs, dirs)
    return out


def test_evaluate_pairs_matches_jax(pairs):
    (want, (jpred, jref)), (got, (ppred, pref)) = pairs["jax"], pairs["port"]
    assert got.shape == want.shape == (3,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)
    names = ["0.png", "1.png", "2.png"]
    for d in (jpred, jref, ppred, pref):
        assert sorted(os.listdir(d)) == names
    for f in names:
        a = np.asarray(Image.open(os.path.join(jref, f)))
        b = np.asarray(Image.open(os.path.join(pref, f)))
        assert a.shape == (SIZE, SIZE, 3) and np.array_equal(a, b)


def test_dir_ssim_psnr_and_uiqm_sweep_match_jax(pairs):
    pred, ref = pairs["port"][1]
    got_s, got_p = evaluate.dir_ssim_psnr(pred, ref, size=SIZE, drop_n=1,
                                          device="cpu")
    want_s, want_p = jax_eval.dir_ssim_psnr(pred, ref, size=SIZE, drop_n=1)
    assert got_s.shape == (3,)
    np.testing.assert_allclose(got_s, want_s, atol=1e-6)
    assert np.array_equal(got_p, want_p)
    for emulate in (True, False):
        got = evaluate.uiqm_sweep(pred, size=SIZE, emulate_cv2=emulate)
        want = jax_eval.uiqm_sweep(pred, size=SIZE, emulate_cv2=emulate)
        assert got.shape == (3,) and np.array_equal(got, want)


def test_loss_sanity_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_perc, "_warned", True)
    monkeypatch.setattr(perceptual, "_warned", True)
    want = jax_eval.loss_sanity(None, 64)
    got = evaluate.loss_sanity(None, 64, device="cpu")
    assert sorted(got) == sorted(want) and len(got) == 14  # 6 need > 160
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, atol=1e-6, err_msg=name)


def _subparsers(main):
    """{subcommand: {dest: (option strings, default, action type)}} of the
    parser that ``main`` builds."""
    seen = {}

    class Stop(Exception):
        pass

    def grab(self, *a, **k):
        seen["parser"] = self
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Stop):
            main([])
    sub = next(a for a in seen["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default,
                            type(a).__name__)
                   for a in sp._actions if a.dest != "help"}
            for name, sp in sub.choices.items()}


def test_subcommand_parsers_match_jax():
    got, want = _subparsers(evaluate.main), _subparsers(jax_eval.main)
    assert sorted(got) == sorted(want) == sorted(
        ["pairs", "infer", "uiqm", "loss-sanity", "ssim-psnr"])
    added = {"pairs": {"compute_dtype", "device"},
             "infer": {"compute_dtype", "device"}, "uiqm": set(),
             "loss-sanity": {"device"}, "ssim-psnr": {"device"}}
    for name in want:
        assert set(got[name]) - set(want[name]) == added[name], name
        assert {k: got[name][k] for k in want[name]} == want[name], name


def test_pairs_and_infer_load_a_trained_checkpoint(tmp_path, monkeypatch):
    """Two steps of the port's CLI on the CPU (NewBigModel-Wavelet, the JAX
    eval CLI's defaults), then ``infer`` and ``pairs`` from the run's
    checkpoint directory without ``-a``/``--use-dwt``."""
    monkeypatch.chdir(tmp_path)
    raw, ref = synthetic_pair_batch(4, 32, seed=7)
    dirs = [_write(tmp_path / "data" / s, x) for s, x in (("a", raw),
                                                         ("b", ref))]
    cli(["--use-cpu", "-a", "NewBigModel", "--use-dwt", "Wavelet",
         "--image-size", "32", "--train-batch-size", "2",
         "--test-batch-size", "2", "--max-epoch", "1", "--use-wandb",
         "--compute-dtype", "float32", "--watch-freq", "0", "-j", "1",
         "--lossf", "fflCharbonnier", "--checkpoint-dir", "ckpt",
         "--train-raw", dirs[0], "--train-ref", dirs[1], "--test-raw",
         dirs[0], "--test-ref", dirs[1]])
    run = os.path.join("ckpt", os.listdir("ckpt")[0])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert sum('"train/loss"' in line for line in f) == 2
    common = ["--weights", os.path.join(run, "best"), "--device", "cpu",
              "--compute-dtype", "fp32", "--batch", "3"]
    n = evaluate.main(["infer", *common, "--input", dirs[0], "--out", "u",
                       "--size", "32"])
    assert n == 4 and sorted(os.listdir("u")) == [f"{i}.png"
                                                  for i in range(4)]
    psnrs = evaluate.main(["pairs", *common, "--test-raw", dirs[0],
                           "--test-ref", dirs[1], "--image-size", "32"])
    assert psnrs.shape == (4,) and np.isfinite(psnrs).all()
    assert sorted(os.listdir("test")) == sorted(os.listdir("ref")) == \
        sorted(os.listdir("u"))
    with pytest.raises(FileNotFoundError):
        evaluate.main(["infer", "--weights", "missing", "--device", "cpu",
                       "--input", dirs[0]])
