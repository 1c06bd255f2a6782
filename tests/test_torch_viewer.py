"""The port's volume viewer (contrastyou_tpu_torch/viewer.py) held against
the JAX package's on the CPU: ``load_volume_from_pngs`` equal to JAX's
(PIL's ``convert("L")``) on grayscale and RGB slices, ``SliceViewer``'s
index clipping, the CLI, and ``show`` naming matplotlib where it is
missing."""
import sys

import numpy as np
import pytest
from PIL import Image

from contrastyou_tpu import viewer as jviewer
from contrastyou_tpu_torch import viewer
from contrastyou_tpu_torch.data.png import write_png


@pytest.mark.parametrize("rgb", [False, True], ids=["grey", "rgb"])
def test_load_volume_equals_jax(tmp_path, rgb):
    rng = np.random.default_rng(int(rgb))
    for i in (3, 0, 11, 2):
        shape = (13, 17, 3) if rgb else (13, 17)
        write_png(tmp_path / f"slice_{i:02d}.png", rng.integers(0, 256, shape, dtype=np.uint8))
    Image.fromarray(np.zeros((2, 2), np.uint8)).save(tmp_path / "ignored.jpg")
    got = viewer.load_volume_from_pngs(tmp_path)
    ref = jviewer.load_volume_from_pngs(tmp_path)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape == (4, 13, 17)
    np.testing.assert_array_equal(got, ref)


def test_slice_index_clips_like_jax():
    vols = [np.zeros((5, 4, 4)), np.ones((5, 4, 4))]
    ours, ref = viewer.SliceViewer(*vols), jviewer.SliceViewer(*vols)
    ref._draw = lambda: None
    assert ours.index == ref.index == 2
    for delta in (1, 1, 1, -1, -7, 3, 10):
        ours._step(delta)
        ref._step(delta)
        assert ours.index == ref.index
    with pytest.raises(ValueError):
        viewer.SliceViewer()


def test_show_names_matplotlib_and_cli(tmp_path, monkeypatch):
    write_png(tmp_path / "a.png", np.zeros((4, 4), np.uint8))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="matplotlib"):
        viewer.main([str(tmp_path)])
    with pytest.raises(SystemExit):
        viewer.main([])
