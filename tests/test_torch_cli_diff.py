"""The port's `diff` subcommand and `run --show` on the CPU, held to the
JAX package's CLI.

`diff a b` on the same files through both packages' ``cli.main``: the
same exit code (0 identical, 1 different, 2 shape mismatch), the same
printed line and the same JSON record (max_abs_diff, differing_pixels,
total_pixels, mse, psnr_db, identical), on gray and RGB images in PNG and
PPM/PGM made from a seed. `run --show` hands the saved array to
``PIL.Image.Image.show`` once, and a viewer that fails leaves the run's
exit code and bytes as they are, with a logged warning.
"""

from __future__ import annotations

import json
import logging

import numpy as np
import pytest
from PIL import Image

from mpi_cuda_imagemanipulation_tpu import cli as jax_cli
from mpi_cuda_imagemanipulation_tpu_torch import cli
from mpi_cuda_imagemanipulation_tpu_torch.io.image import save_image, synthetic_image


def _pair(tmp_path, case: str, channels: int, ext: str):
    """Two image files for `case`, written by the port's writer."""
    a = synthetic_image(23, 31, channels=channels, seed=7)
    b = a.copy()
    if case == "one-off":
        b[5, 9, ...] ^= 1
    elif case == "many-off":
        rng = np.random.default_rng(3)
        mask = rng.random(a.shape[:2]) < 0.3
        b[mask] = rng.integers(0, 256, size=b[mask].shape, dtype=np.uint8)
    elif case == "shape":
        b = b[:-2]
    pa, pb = tmp_path / f"a{ext}", tmp_path / f"b{ext}"
    save_image(str(pa), a)
    save_image(str(pb), b)
    return pa, pb


def _diff(main, pa, pb, out, capsys):
    rc = main(["diff", str(pa), str(pb), "--json-metrics", str(out)])
    line = capsys.readouterr().out
    rec = json.loads(out.read_text()) if out.exists() else None
    return rc, line, rec


@pytest.mark.parametrize("ext", [".png", ".ppm"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("case", ["identical", "one-off", "many-off", "shape"])
def test_diff_equals_the_jax_cli(tmp_path, capsys, case, channels, ext):
    if ext == ".ppm" and channels == 1:
        ext = ".pgm"
    pa, pb = _pair(tmp_path, case, channels, ext)
    got = _diff(cli.main, pa, pb, tmp_path / "port.json", capsys)
    want = _diff(jax_cli.main, pa, pb, tmp_path / "jax.json", capsys)
    assert got == want
    rc, _line, rec = got
    assert rc == {"identical": 0, "one-off": 1, "many-off": 1, "shape": 2}[case]
    assert rec["identical"] is (case == "identical")
    if case == "identical":
        assert rec["psnr_db"] == float("inf") and rec["mse"] == 0.0
    if case == "one-off":
        # three values either way: all channels flipped, or gray loaded as RGB
        assert rec["differing_pixels"] == 3 and rec["max_abs_diff"] == 1
        assert rec["psnr_db"] == pytest.approx(10 * np.log10(255.0**2 / rec["mse"]))


def test_diff_json_to_stdout_matches(tmp_path, capsys):
    pa, pb = _pair(tmp_path, "many-off", 3, ".png")
    got = []
    for main in (cli.main, jax_cli.main):
        rc = main(["diff", str(pa), str(pb), "--json-metrics", "-"])
        got.append((rc, capsys.readouterr().out))
    assert got[0] == got[1]
    rc, out = got[0]
    line, rec = out.splitlines()
    assert rc == 1 and line.startswith("DIFFERENT: maxdiff ")
    assert json.loads(rec)["event"] == "diff"


@pytest.fixture
def show_calls(monkeypatch):
    calls = []

    def fake_show(self, title=None, **kw):
        calls.append((np.asarray(self), title))

    monkeypatch.setattr(Image.Image, "show", fake_show)
    return calls


@pytest.fixture
def warnings_seen():
    logger = logging.getLogger("mcim_torch")
    records: list[logging.LogRecord] = []
    handler = logging.Handler(level=logging.WARNING)
    handler.emit = records.append
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)


def _run(tmp_path, name: str, *extra: str) -> int:
    return cli.main(["run", "--input", str(tmp_path / "in.png"), "--output",
                     str(tmp_path / name), "--device", "cpu", "--impl", "torch", *extra])


def test_run_show_displays_the_saved_array(tmp_path, show_calls):
    Image.fromarray(synthetic_image(20, 28, seed=4)).save(tmp_path / "in.png")
    assert _run(tmp_path, "shown.png", "--show") == 0
    assert len(show_calls) == 1
    arr, title = show_calls[0]
    np.testing.assert_array_equal(arr, np.asarray(Image.open(tmp_path / "shown.png")))
    assert title == str(tmp_path / "shown.png")


def test_run_show_failure_is_a_warning(tmp_path, monkeypatch, warnings_seen):
    Image.fromarray(synthetic_image(20, 28, seed=5)).save(tmp_path / "in.png")
    assert _run(tmp_path, "plain.png") == 0

    def broken(self, title=None, **kw):
        raise OSError("no display")

    monkeypatch.setattr(Image.Image, "show", broken)
    assert _run(tmp_path, "shown.png", "--show") == 0
    assert (tmp_path / "shown.png").read_bytes() == (tmp_path / "plain.png").read_bytes()
    msgs = [r.getMessage() for r in warnings_seen]
    assert any("--show failed" in m and "no display" in m for m in msgs), msgs
