"""The port's LPIPS weight fetcher (``tools/fetch_lpips_weights.py``)
against the JAX package's, on fabricated state dicts. No test downloads:
``_download`` is replaced by a stub that returns ``torch.save`` bytes."""

import io

import numpy as np
import pytest
import torch

from skelsplat_tpu.tools import fetch_lpips_weights as jfetch
from skelsplat_tpu_torch.ops import lpips as tlpips
from skelsplat_tpu_torch.tools import fetch_lpips_weights as tfetch

# torchvision's feature indices of each backbone's convolutions
CONV_KEYS = {"alex": [f"features.{i}" for i in (0, 3, 6, 8, 10)],
             "vgg": [f"features.{i}" for i in (0, 2, 5, 7, 10, 12, 14, 17,
                                                19, 21, 24, 26, 28)]}


def _state_dicts(net_type, seed=7):
    """(backbone, lin) state dicts in torchvision's and LPIPS' layouts."""
    rng = np.random.default_rng(seed)
    backbone = {}
    for key, shape in zip(CONV_KEYS[net_type],
                          tlpips._conv_shapes(net_type), strict=True):
        backbone[f"{key}.weight"] = rng.normal(0, 0.05, shape).astype(
            np.float32)
        backbone[f"{key}.bias"] = rng.normal(0, 0.05, shape[0]).astype(
            np.float32)
    backbone["classifier.0.weight"] = rng.normal(0, 1, (10, 10))
    lin = {f"lin{i}.model.1.weight":
           rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32)
           for i, c in enumerate(tlpips.BACKBONES[net_type]["n_channels"])}
    return backbone, lin


@pytest.mark.parametrize("net_type", ["alex", "vgg"])
def test_convert_state_dicts_matches_jax(net_type):
    backbone, lin = _state_dicts(net_type)
    want = jfetch.convert_state_dicts(backbone, lin, net_type)
    as_tensors = ({k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
                  for d in (backbone, lin))
    for got in (tfetch.convert_state_dicts(backbone, lin, net_type),
                tfetch.convert_state_dicts(*as_tensors, net_type)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k
    bad = dict(backbone)
    key = f"{CONV_KEYS[net_type][0]}.weight"
    bad[key] = np.zeros((7,) + bad[key].shape[1:], np.float32)
    for mod in (tfetch, jfetch):
        with pytest.raises(ValueError, match="shape"):
            mod.convert_state_dicts(bad, lin, net_type)


def _saved(sd) -> bytes:
    buf = io.BytesIO()
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32))
                for k, v in sd.items()}, buf)
    return buf.getvalue()


def test_fetch_checks_the_pin_and_writes_a_loadable_npz(tmp_path,
                                                        monkeypatch):
    backbone, lin = _state_dicts("alex")
    blobs = {"backbone": _saved(backbone), "lin": _saved(lin)}
    fetched = []

    def download(url):
        fetched.append(url)
        return blobs["lin" if url == tfetch.LIN_URL.format(net="alex")
                     else "backbone"]

    monkeypatch.setattr(tfetch, "_download", download)
    with pytest.raises(RuntimeError, match="pinned"):
        tfetch.fetch_one("alex", str(tmp_path))
    assert not list(tmp_path.iterdir())

    pin = tfetch._sha256(blobs["backbone"])[:8]
    monkeypatch.setitem(tfetch.BACKBONE_URLS, "alex",
                        f"https://download.pytorch.org/models/alexnet-{pin}"
                        ".pth")
    tfetch.main(["--out", str(tmp_path / "w"), "--nets", "alex"])
    assert fetched[-2:] == [tfetch.BACKBONE_URLS["alex"],
                            tfetch.LIN_URL.format(net="alex")]
    path = tmp_path / "w" / "alex.npz"
    with np.load(path) as data:
        assert str(data["lin_sha256"]) == tfetch._sha256(blobs["lin"])
        assert np.array_equal(data["conv0_w"], backbone["features.0.weight"])
    model = tlpips.LPIPS.from_npz(str(path), device="cpu")
    assert model.net_type == "alex"
    x = torch.rand(1, 3, 64, 64) * 2 - 1
    assert float(model(x, x)[0]) == pytest.approx(0.0, abs=1e-6)
    assert float(model(x, -x)[0]) > 0


def test_default_out_is_the_ports_weights_dir(monkeypatch):
    outs = []
    monkeypatch.setattr(tfetch, "fetch_one",
                        lambda net, out: outs.append((net, out)))
    monkeypatch.setattr(tfetch.os, "makedirs", lambda *a, **k: None)
    tfetch.main([])
    assert outs == [(n, tlpips.WEIGHTS_DIR) for n in ("vgg", "alex",
                                                      "squeeze")]
    assert tlpips.default_weights_path("vgg") in (
        None, f"{tlpips.WEIGHTS_DIR}/vgg.npz")
