"""``rollingdepth_torch.aligner.frame_table`` and ``frame_sum``: the one
fixed order in which the port sums windows into frames.

- the table (``hypothesis`` over clip length, window length, dilation and
  phase, for stride-1 and partition windows and both at once): each frame
  lists exactly the window rows that cover it, in ascending order, empty
  slots point at the zero row, and each count equals ``coverage_count``;
- the sum is bit-equal to a Python loop over each frame's slots in the
  table's order, and within 1e-6 relative of the JAX package's one-hot
  formulation (``oh.T @ a`` with ``_onehot_tables``' one-hots), on positive
  rows so that no sum cancels;
- the tiny depth pipeline (latent solve, refinement over partition or
  stride-1 windows) runs with every scatter-add refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rollingdepth_torch.aligner import frame_sum, frame_table
from rollingdepth_torch.pipelines.snippets import coverage_count, partition_index_matrix, snippet_index_matrix
from rollingdepth_tpu.aligner import _onehot_tables


def _mats(kind, seq_len, w, d, phase):
    mats = []
    if kind in ("snippet", "both"):
        mats.append(snippet_index_matrix(seq_len, w, d))
    if kind in ("partition", "both"):
        mats.append(partition_index_matrix(seq_len, w, d, phase=phase))
    return mats


@st.composite
def windows(draw):
    w = draw(st.integers(1, 5))
    d = draw(st.integers(1, 6))
    seq_len = draw(st.integers((w - 1) * d + 1, 40))
    return seq_len, w, d, draw(st.integers(0, 7))


@pytest.mark.parametrize("kind", ["snippet", "partition", "both"])
@settings(max_examples=60, deadline=None)
@given(case=windows())
def test_table_lists_every_covering_row_in_ascending_order(kind, case):
    seq_len, w, d, phase = case
    mats = _mats(kind, seq_len, w, d, phase)
    flat = np.concatenate([m.reshape(-1) for m in mats])
    table, counts = frame_table(mats, seq_len)
    np.testing.assert_array_equal(counts, coverage_count(flat, seq_len))
    assert table.shape == (seq_len, counts.max())
    for t in range(seq_len):
        rows = np.flatnonzero(flat == t)  # ascending
        np.testing.assert_array_equal(table[t, : counts[t]], rows)
        assert (table[t, counts[t] :] == flat.size).all()


def test_table_refuses_a_window_past_the_clip():
    with pytest.raises(ValueError, match="covers frame 9"):
        frame_table([snippet_index_matrix(10, 3, 2)], 9)


def _rows(mats, p, seed):
    rng = np.random.default_rng(seed)
    n = sum(m.size for m in mats)
    return np.concatenate([rng.uniform(0.5, 1.5, (n, p)), np.zeros((1, p))]).astype(np.float32)


@pytest.mark.parametrize("seq_len, dilations, p", [(10, (1, 3), 37), (60, (1, 25), 64), (51, (1, 10, 25), 16)])
def test_sum_is_the_slot_loop(seq_len, dilations, p):
    mats = [snippet_index_matrix(seq_len, 3, d) for d in dilations]
    table, counts = frame_table(mats, seq_len)
    rows = torch.from_numpy(_rows(mats, p, seq_len))
    got = frame_sum(rows, torch.from_numpy(table))
    for t in range(seq_len):
        want = rows[table[t, 0]]
        for k in range(1, table.shape[1]):
            want = want + rows[table[t, k]]
        assert torch.equal(got[t], want), t


def test_sum_of_no_rows_is_zero():
    table, counts = frame_table([np.zeros((0, 3), np.int64)], 5)
    assert table.shape == (5, 0) and not counts.any()
    assert torch.equal(frame_sum(torch.zeros((1, 2, 3)), torch.from_numpy(table)), torch.zeros((5, 2, 3)))


@pytest.mark.parametrize("kind", ["snippet", "partition", "both"])
@pytest.mark.parametrize("seq_len, w, d, phase", [(10, 3, 1, 0), (60, 3, 25, 0), (33, 4, 5, 3)])
def test_sum_matches_jax_onehot(kind, seq_len, w, d, phase):
    mats = _mats(kind, seq_len, w, d, phase)
    table, counts = frame_table(mats, seq_len)
    rows = _rows(mats, 48, seq_len + w)
    onehots, jcounts = _onehot_tables(mats, seq_len, [m.shape[0] for m in mats], seq_len)
    want = np.asarray(jnp.concatenate(onehots).T @ jnp.asarray(rows[:-1]))
    got = frame_sum(torch.from_numpy(rows), torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def refuse_scatter_adds(monkeypatch) -> None:
    """Make every scatter-add that PyTorch offers in Python raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("a scatter-add was reached")

    for name in ("index_add_", "index_add", "scatter_add_", "scatter_add", "index_put_", "put_"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "index_add", refuse)
    monkeypatch.setattr(torch, "scatter_add", refuse)


@pytest.mark.parametrize("turbo_refine", [True, False])
def test_depth_pipeline_reaches_no_scatter_add(monkeypatch, turbo_refine):
    """The tiny depth pipeline through the latent solve and two refine steps
    over partition (turbo) or stride-1 windows, with every scatter-add
    refused."""
    from rollingdepth_torch.tools.multihost_demo import build_pipeline, clip

    pipe = build_pipeline("cpu")
    refuse_scatter_adds(monkeypatch)
    out = pipe.forward(clip(0), dilations=[1, 2], refine_step=2, turbo_refine=turbo_refine, seed=0, max_vae_bs=4,
                       merge_in_latent=True, latent_coalign_kwargs={"num_iterations": 3})
    assert out.depth_pred.shape == (8, 1, 32, 48) and np.isfinite(out.depth_pred).all()
