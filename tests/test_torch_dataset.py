"""The port's datasets and loaders held against flamo_tpu's on the CPU.

Each item's input is its own index, so a batch shows which items the
loader gathered: the split and the shuffled batch order must equal the
JAX package's index for index (both draw from numpy's
``default_rng(seed)``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flamo_tpu.optimize.dataset as jd
from flamo_tpu_torch.optimize import dataset as td


def _indexed(mod, n: int, **kw):
    x = np.arange(n, dtype=np.float32).reshape(n, 1, 1)
    return mod.Dataset(input=x, target=2 * x, expand=n, **kw)


def _indices(loader, passes: int = 2):
    out = []
    for _ in range(passes):
        for xb, yb in loader:
            xb, yb = np.asarray(xb), np.asarray(yb)
            assert np.array_equal(yb, 2 * xb)
            out.append(xb[:, 0, 0].astype(int).tolist())
    return out


@pytest.mark.parametrize("seed", [0, 7, 130709])
def test_split_and_shuffle_match_jax(seed):
    n, bs = 23, 3
    tj, vj = jd.load_dataset(_indexed(jd, n), batch_size=bs, split=0.8,
                             seed=seed)
    tt, vt = td.load_dataset(_indexed(td, n, device="cpu"), batch_size=bs,
                             split=0.8, seed=seed)
    assert tt.dataset.indices.tolist() == tj.dataset.indices.tolist()
    assert vt.dataset.indices.tolist() == vj.dataset.indices.tolist()
    for lj, lt in ((tj, tt), (vj, vt)):
        assert len(lt) == len(lj)
        assert _indices(lt) == _indices(lj)


def test_lengths_and_drop_last():
    ds = _indexed(td, 10, device="cpu")
    assert len(ds) == 10
    train, valid = td.split_dataset(ds, 0.8, seed=1)
    assert (len(train), len(valid)) == (8, 2)
    loader = td.get_dataloader(train, batch_size=3, shuffle=False)
    assert len(loader) == 2  # 8 items, batches of 3: the ragged 2 dropped
    batches = _indices(loader, passes=1)
    assert batches == [train.indices[:3].tolist(),
                       train.indices[3:6].tolist()]
    assert len(td.get_dataloader(valid, batch_size=3)) == 0
    assert list(td.get_dataloader(valid, batch_size=3)) == []


def test_colorless_dataset_and_stack_loader():
    M = 17
    ds = td.DatasetColorless(input_shape=(1, M, 2), target_shape=(1, M, 2),
                             expand=12, device="cpu")
    assert ds.input.shape == (12, M, 2) and ds.device.type == "cpu"
    assert torch.equal(ds.input[3, 0], torch.ones(2))
    assert float(ds.input[:, 1:].abs().sum()) == 0.0
    assert torch.equal(ds.target, torch.ones(12, M, 2))
    train, _ = td.load_dataset(ds, batch_size=2, split=0.75, seed=0)
    bx, bt = td.stack_loader(train)
    assert bx.shape == (4, 2, M, 2) and bt.shape == (4, 2, M, 2)
    assert bx.dtype == torch.float32
    with pytest.raises(ValueError):
        td.stack_loader(td.get_dataloader(train, batch_size=100))
