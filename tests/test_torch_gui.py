"""The port's GUI layer (`libstevi_tpu_torch/gui`) against the JAX
package's (`libstevi_tpu/gui`): the display adapters give the same RGB
(numpy arrays and tensors alike), and the viewer's handlers follow
`tests/test_gui.py`, driven with synthetic events on the Agg backend."""

import types

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)

from libstevi_tpu import gui as j_gui
from libstevi_tpu_torch import gui as t_gui
from libstevi_tpu_torch.gui import (ArrayDisplayAdapter,
                                    GrayscaleArrayDisplayAdapter,
                                    InteractiveViewer)

_rng = np.random.default_rng(3)
GRAY = _rng.uniform(-2, 7, (13, 17)).astype(np.float32)
RGB = _rng.uniform(0, 1, (9, 11, 3)).astype(np.float32)


@pytest.mark.parametrize("cmap", ["gray", "viridis", "turbo", "jet"])
@pytest.mark.parametrize("levels", [(None, None), (-1.0, 4.0)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_grayscale_adapter_equals_jax(cmap, levels, as_tensor):
    arr = torch.from_numpy(GRAY) if as_tensor else GRAY
    got = GrayscaleArrayDisplayAdapter(arr, *levels, colormap=cmap).to_rgb()
    want = j_gui.GrayscaleArrayDisplayAdapter(GRAY, *levels,
                                              colormap=cmap).to_rgb()
    assert got.dtype == np.uint8 and got.shape == (13, 17, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [(0, 1, 2), (2, 1, 0), (0, 0, 5)])
def test_array_adapter_equals_jax(channels):
    for arr in (RGB, RGB[..., 0], torch.from_numpy(RGB).bfloat16()):
        ref = arr.float().numpy() if isinstance(arr, torch.Tensor) else arr
        got = ArrayDisplayAdapter(arr, channels=channels).to_rgb()
        want = j_gui.ArrayDisplayAdapter(ref, channels=channels).to_rgb()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("invalid", [None, -1.0])
def test_disparity_to_color_equals_jax(invalid):
    d = GRAY.copy()
    d[2, 3] = np.nan
    d[4, 5] = -1.0
    got = t_gui.disparity_to_color(torch.from_numpy(d), invalid)
    want = j_gui.disparity_to_color(d, invalid)
    np.testing.assert_array_equal(got, want)
    assert (got[2, 3] == 0).all()
    full = t_gui.disparity_to_color(GRAY, colormap="gray")
    np.testing.assert_array_equal(
        full, j_gui.disparity_to_color(GRAY, colormap="gray"))


def _ev(**kw):
    e = types.SimpleNamespace(xdata=None, ydata=None, x=0, y=0,
                              button=None, key=None)
    for k, v in kw.items():
        setattr(e, k, v)
    return e


@pytest.fixture
def viewer():
    rng = np.random.default_rng(0)
    v = InteractiveViewer(torch.from_numpy(
        rng.uniform(0, 10, (40, 60)).astype(np.float32)))
    yield v
    import matplotlib.pyplot as plt
    plt.close(v.fig)


def test_adapter_windowing():
    a = np.linspace(0, 1, 12).reshape(3, 4).astype(np.float32)
    rgb = GrayscaleArrayDisplayAdapter(a, black_level=0.25,
                                       white_level=0.75,
                                       colormap="gray").to_rgb()
    assert rgb.shape == (3, 4, 3)
    assert rgb[0, 0, 0] == 0
    assert rgb[-1, -1, 0] == 255


def test_viewer_renders_jax_rgb(viewer):
    import matplotlib.pyplot as plt
    rgb = viewer.rgb()
    assert rgb.shape == (40, 60, 3) and rgb.dtype == np.uint8
    jv = j_gui.InteractiveViewer(viewer.data)
    np.testing.assert_array_equal(rgb, jv.rgb())
    plt.close(jv.fig)
    color = InteractiveViewer(RGB, title="rgb")
    assert color.rgb().shape == (9, 11, 3)
    plt.close(color.fig)


def test_scroll_zooms_about_cursor(viewer):
    x0 = viewer.ax.get_xlim()
    viewer.on_scroll(_ev(xdata=30.0, ydata=20.0, button="up"))
    x1 = viewer.ax.get_xlim()
    assert (x1[1] - x1[0]) < (x0[1] - x0[0])
    rel0 = (30.0 - x0[0]) / (x0[1] - x0[0])
    rel1 = (30.0 - x1[0]) / (x1[1] - x1[0])
    assert rel0 == pytest.approx(rel1, abs=1e-9)
    viewer.on_scroll(_ev(xdata=30.0, ydata=20.0, button="down"))
    x2 = viewer.ax.get_xlim()
    assert (x2[1] - x2[0]) == pytest.approx(x0[1] - x0[0])
    viewer.on_scroll(_ev(button="up"))               # outside the axes
    assert viewer.ax.get_xlim() == x2


def test_drag_pans(viewer):
    viewer.on_press(_ev(xdata=10.0, ydata=10.0, button=1))
    viewer.on_motion(_ev(xdata=15.0, ydata=12.0))
    viewer.on_release(_ev())
    x0, x1 = viewer.ax.get_xlim()
    assert x0 == pytest.approx(-5.5)
    viewer.on_motion(_ev(xdata=40.0, ydata=40.0))      # released: no pan
    assert viewer.ax.get_xlim()[0] == pytest.approx(-5.5)


def test_right_drag_level_window(viewer):
    b0, w0 = viewer.black, viewer.white
    viewer.on_press(_ev(button=3, x=100, y=100))
    viewer.on_motion(_ev(x=160, y=100, xdata=None, ydata=None))
    assert viewer.black > b0
    assert viewer.white - viewer.black == pytest.approx(w0 - b0)
    viewer.on_motion(_ev(x=100, y=300, xdata=None, ydata=None))
    assert viewer.white - viewer.black > (w0 - b0)
    viewer.on_release(_ev())


def test_reset_and_colormap_cycle(viewer):
    viewer.on_scroll(_ev(xdata=30.0, ydata=20.0, button="up"))
    viewer.on_press(_ev(button=3, x=0, y=0))
    viewer.on_motion(_ev(x=50, y=50, xdata=None, ydata=None))
    viewer.on_release(_ev())
    viewer.on_key(_ev(key="r"))
    assert viewer.ax.get_xlim() == viewer._home[0]
    assert (viewer.black, viewer.white) == viewer._full_range
    before = viewer.rgb().copy()
    viewer.on_key(_ev(key="c"))
    assert (viewer.rgb() != before).any()
    viewer.on_key(_ev(key="g"))
    assert any(gl.get_visible() for gl in viewer.ax.get_xgridlines())


def test_value_readout(viewer):
    s = viewer._format_coord(12.2, 7.8)
    assert "x=12 y=8" in s and "value=" in s
    assert f"{viewer.data[8, 12]:.4g}" in s
    assert viewer._format_coord(-5.0, 3.0) == "x=-5.0 y=3.0"
