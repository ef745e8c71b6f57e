"""Port parity for AdamW, its schedules and global-norm clipping
(``repro_torch/train/optimizer.py`` against ``repro/train/optimizer.py``).

The same NumPy trees go through both packages on the CPU, in the
reference's stacked layout (``blocks/sub0/...`` leaves of (n_groups, ...)).
Schedules and clipping to 1e-6; ``update`` to 1e-6 over three steps.  The
decay rule reads the stacked rank: a block's norm scale (n_groups, d) is
decayed, the final norm's (d,) is not -- a per-layer reading, (d,) for
both, would leave the block's scale undecayed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as topt

SHAPES = {"blocks/sub0/attn/wq": (2, 8, 2, 4),
          "blocks/sub0/ln1/scale": (2, 8),
          "embed/emb": (16, 8),
          "final_norm/scale": (8,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _nested(flat):
    """The reference's nested dict for flat '/'-joined keys."""
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = jnp.asarray(v)
    return out


def _get(nested, key):
    for part in key.split("/"):
        nested = nested[part]
    return np.asarray(nested)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-3, warmup_steps=7, total_steps=40, schedule=schedule)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    for step in (0, 1, 3, 7, 8, 20, 39, 40, 55):
        want = float(jopt.schedule_lr(jc, jnp.asarray(step, jnp.int32)))
        got = float(topt.schedule_lr(tc, torch.tensor(step,
                                                      dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(1, scale=0.3)
    jg, jn = jopt.clip_by_global_norm(_nested(g), max_norm)
    tg, tn = topt.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tg[k].numpy(), _get(jg, k), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_adamw_update_matches_reference(schedule):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              clip_norm=1.0, schedule=schedule)
    jinit, jupd = jopt.adamw(jopt.AdamWConfig(**kw))
    tinit, tupd = topt.adamw(topt.AdamWConfig(**kw))
    p = _tree(2)
    jp, tp = _nested(p), {k: torch.from_numpy(v) for k, v in p.items()}
    js, ts = jinit(jp), tinit(tp)
    for step in range(3):
        g = _tree(10 + step, scale=0.5)
        jp, js, jm = jupd(_nested(g), js, jp)
        tp, ts, tm = tupd({k: torch.from_numpy(v) for k, v in g.items()},
                          ts, tp)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for k in p:
            for got, want in ((tp[k], _get(jp, k)),
                              (ts.mu[k], _get(js.mu, k)),
                              (ts.nu[k], _get(js.nu, k))):
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-6, err_msg=k)
        assert int(ts.step) == int(js.step) == step + 1


def test_inplace_update_equals_the_new_tensors():
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    init, upd = topt.adamw(cfg)
    p = {k: torch.from_numpy(v) for k, v in _tree(3).items()}
    g = {k: torch.from_numpy(v) for k, v in _tree(4).items()}
    new, st, _ = upd(g, init(p), p)
    q = {k: v.clone() for k, v in p.items()}
    st_q = init(q)
    donated, st2, _ = upd(g, st_q, q, inplace=True)
    for k in p:
        assert donated[k] is q[k] and st2.mu[k] is st_q.mu[k]
        torch.testing.assert_close(donated[k], new[k], rtol=0, atol=0)
        torch.testing.assert_close(st2.nu[k], st.nu[k], rtol=0, atol=0)


def test_decay_rank_is_the_stacked_leafs():
    """With a zero gradient, AdamW's step is the decay alone:
    p * (1 - lr * wd) on a leaf of rank >= 2 in the reference's stacked
    layout.  A block norm's scale is (n_groups, d) there and decays; the
    final norm's (d,) does not.  Read per layer, the block scale would be
    (d,) and stay put."""
    cfg = topt.AdamWConfig(lr=0.5, warmup_steps=0, total_steps=10,
                           weight_decay=0.2, schedule="constant")
    init, upd = topt.adamw(cfg)
    p = {k: torch.from_numpy(v) for k, v in _tree(5).items()}
    zero = {k: torch.zeros_like(v) for k, v in p.items()}
    new, _, _ = upd(zero, init(p), p)
    block = "blocks/sub0/ln1/scale"
    torch.testing.assert_close(new[block], p[block] * (1 - 0.5 * 0.2))
    torch.testing.assert_close(new["final_norm/scale"],
                               p["final_norm/scale"], rtol=0, atol=0)
    # the per-layer reading leaves a (d,) slice of the block scale alone
    per_layer, _, _ = upd({"s": zero[block][0]}, init({"s": p[block][0]}),
                          {"s": p[block][0]})
    assert torch.equal(per_layer["s"], p[block][0])
    assert not torch.equal(new[block][0], p[block][0])
    # and the reference agrees with the stacked reading
    jinit, jupd = jopt.adamw(jopt.AdamWConfig(
        lr=0.5, warmup_steps=0, total_steps=10, weight_decay=0.2,
        schedule="constant"))
    jp = _nested({k: v.numpy() for k, v in p.items()})
    jnew, _, _ = jupd(_nested({k: v.numpy() for k, v in zero.items()}),
                      jinit(jp), jp)
    np.testing.assert_allclose(new[block].numpy(), _get(jnew, block),
                               rtol=1e-6)
