"""posetpu_torch's data layer against the JAX package's: the annotation
schema, the datasets' metadata, image-header and mean caches, and the
synthetic split.  Everything here is exact: the same files, the same
float64 values, the same bytes."""

import json
import os
import shutil

import numpy as np
import pytest

from posetpu.data.datasets import LspDataset as RefLsp
from posetpu.data.datasets import MpiiDataset as RefMpii
from posetpu.data.schema import dump_annotations as ref_dump
from posetpu.data.schema import load_annotations as ref_load
from posetpu.data.synthetic import make_synthetic_dataset as ref_make
from posetpu_torch.data import (
    LspDataset,
    MpiiDataset,
    dump_annotations,
    load_annotations,
    make_synthetic_dataset,
)


def _ann(i, center, scale=1.1, val=0.0, head=None, rel=None, K=16):
    rng = np.random.RandomState(i)
    a = {
        "img_paths": rel or f"im_{i}.jpg",
        "objpos": list(center),
        "scale_provided": scale,
        "joint_self": [[float(x), float(y), float(v)] for (x, y), v in
                       zip(rng.uniform(1, 300, (K, 2)), rng.randint(0, 2, K))],
        "isValidation": val,
    }
    if head is not None:
        a[head] = [10.0 + i, 20.0, 40.5 + i, 71.25]
    return a


def _raw():
    """Centers with x in [0, 1), the -1 sentinel, and ordinary ones;
    head boxes under both names; a subdirectory in img_paths."""
    return [
        _ann(0, (0.4, 120.0)),
        _ann(1, (-1.0, -1.0), val=1.0),
        _ann(2, (150.5, 99.5), head="headboxes"),
        _ann(3, (1.0, 5.0), val=1.0, head="head_rect", rel="sub/im_3.jpg"),
        _ann(4, (0.0, 0.0), scale=0.37),
        _ann(5, (200.25, 80.0), val=1.0, head="headboxes"),
    ]


@pytest.mark.parametrize("layout", ["list", "samples", "annotations"])
def test_load_and_dump_round_trip_like_reference(tmp_path, layout):
    raw = _raw()
    doc = raw if layout == "list" else {layout: raw}
    src = tmp_path / "src.json"
    src.write_text(json.dumps(doc))
    got, want = load_annotations(str(src), "imgs"), ref_load(str(src), "imgs")
    assert len(got) == len(want) == len(raw)
    for g, w in zip(got, want):
        assert g.img_path == w.img_path and g.img_rel == w.img_rel
        assert g.scale == w.scale and g.is_validation == w.is_validation
        for f in ("center", "pts", "vis"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)
        assert (g.head_rect is None) == (w.head_rect is None)
        if g.head_rect is not None:
            np.testing.assert_array_equal(g.head_rect, w.head_rect)
    dump_annotations(got, str(tmp_path / "port.json"))
    ref_dump(want, str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    again = load_annotations(str(tmp_path / "port.json"), "imgs")
    assert [s.img_path for s in again] == [s.img_path for s in got]
    assert again[3].img_path == os.path.join("imgs", "sub/im_3.jpg")
    np.testing.assert_array_equal(again[2].head_rect, got[2].head_rect)


@pytest.mark.parametrize("split", ["train", "valid", "all"])
def test_meta_and_head_size_equal_reference(tmp_path, split):
    src = tmp_path / "a.json"
    src.write_text(json.dumps(_raw()))
    ds, ref = MpiiDataset(str(src), "imgs", split), RefMpii(str(src), "imgs", split)
    assert len(ds) == len(ref) > 0
    for i in range(len(ds)):
        (c, s, p, v), (rc, rs, rp, rv) = ds.meta(i), ref.meta(i)
        np.testing.assert_array_equal(c, rc)
        assert s == rs
        np.testing.assert_array_equal(p, rp)
        np.testing.assert_array_equal(v, rv)
        assert ds.image_path(i) == ref.image_path(i)
        assert ds.head_size(i) == ref.head_size(i)
    if split == "all":
        # x in [0, 1) is adjusted; only the exact -1 sentinel is not
        c, s, _, _ = ds.meta(0)
        assert c[1] == 120.0 + 15.0 * 1.1 and s == 1.1 * 1.25
        c, s, _, _ = ds.meta(1)
        assert c[1] == -1.0 and s == 1.1
        assert ds.head_size(0) is None and ds.head_size(2) is not None


def _split(tmp_path, name, **kw):
    root = tmp_path / name
    ref_make(str(root), **kw)
    return root


def test_max_image_hw_and_mean_std_equal_reference_with_split_caches(tmp_path):
    root = _split(tmp_path, "ref", num_train=5, num_val=3, res=(96, 72), seed=4)
    port_root = tmp_path / "port"
    shutil.copytree(root, port_root)
    for split in ("train", "valid"):
        ref = RefMpii(str(root / "annotations.json"), str(root / "images"), split)
        ds = MpiiDataset(str(port_root / "annotations.json"),
                         str(port_root / "images"), split)
        assert ds.max_image_hw() == ref.max_image_hw() == (72, 96)
        (m, s), (rm, rs) = ds.mean_std(), ref.mean_std()
        assert m.dtype == s.dtype == np.float32
        np.testing.assert_array_equal(m, rm)
        np.testing.assert_array_equal(s, rs)
        for name in (f"mpii_{split}_mean.json", f"mpii_{split}_maxhw.json"):
            assert (port_root / name).read_bytes() == (root / name).read_bytes()
    # the caches are read back, per split: a planted value comes back
    (port_root / "mpii_valid_maxhw.json").write_text('{"h": 7, "w": 9}')
    (port_root / "mpii_train_mean.json").write_text(
        '{"mean": [0.5, 0.25, 0.125], "std": [1, 2, 3]}')
    train = MpiiDataset(str(port_root / "annotations.json"), str(port_root / "images"))
    valid = MpiiDataset(str(port_root / "annotations.json"), str(port_root / "images"),
                        "valid")
    assert valid.max_image_hw() == (7, 9) and train.max_image_hw() == (72, 96)
    np.testing.assert_array_equal(train.mean_std()[0], [0.5, 0.25, 0.125])
    assert not [n for n in os.listdir(port_root) if n.endswith(".tmp")]


@pytest.mark.parametrize("kw", [
    dict(dataset="mpii", head_rects=True, seed=3),
    dict(dataset="lsp", seed=5),
    dict(dataset="mpii", hard_val=True, seed=7),
], ids=["mpii_head_rects", "lsp", "mpii_hard_val"])
def test_synthetic_split_same_files_as_reference(tmp_path, kw):
    args = dict(num_train=4, num_val=3, res=(80, 64), **kw)
    ref_make(str(tmp_path / "ref"), **args)
    json_path = make_synthetic_dataset(str(tmp_path / "port"), **args)
    assert json_path == str(tmp_path / "port" / "annotations.json")
    assert ((tmp_path / "port" / "annotations.json").read_bytes()
            == (tmp_path / "ref" / "annotations.json").read_bytes())
    names = sorted(os.listdir(tmp_path / "ref" / "images"))
    assert names == sorted(os.listdir(tmp_path / "port" / "images")) and len(names) == 7
    for n in names:
        assert ((tmp_path / "port" / "images" / n).read_bytes()
                == (tmp_path / "ref" / "images" / n).read_bytes()), n
    cls, ref_cls = (LspDataset, RefLsp) if kw["dataset"] == "lsp" else (MpiiDataset, RefMpii)
    ds = cls(json_path, str(tmp_path / "port" / "images"), "valid")
    ref = ref_cls(str(tmp_path / "ref" / "annotations.json"),
                  str(tmp_path / "ref" / "images"), "valid")
    assert ds.num_joints == ref.num_joints == ds.meta(0)[2].shape[0]
    assert [ds.head_size(i) for i in range(3)] == [ref.head_size(i) for i in range(3)]


def test_lsp_head_rects_refused_like_reference(tmp_path):
    with pytest.raises(ValueError, match="MPII-schema"):
        make_synthetic_dataset(str(tmp_path), dataset="lsp", head_rects=True)
