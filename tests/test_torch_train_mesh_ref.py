"""The port's sharded train step against the reference's sharded step.

The reference's ``make_train_step`` is jitted under
``repro.distributed.sharding.activate`` over a (2, 2) (data, model) JAX
mesh of the four CPU devices ``tests/conftest.py`` forces, as
``src/repro/launch/train.py`` runs it on its production mesh (GSPMD
shards the step by the logical-axis rules).  The port runs its step
placed on a (2, 2) ``DeviceMesh`` of four gloo ranks
(``_torch_mesh_worker.RankPool``).  Both start from the reference's
``init_state`` flattened as its checkpoints flatten it (carried across by
``convert.train_state_from_numpy``) and take the reference's batches, 3
fp32 steps; the tolerances are ``tests/test_torch_train.py``'s: loss
1e-5, parameters and moments 1e-4.  granite_3_8b (dense GQA, 2
microbatches, remat) and grok_1_314b (MoE routing, whose capacity drops
depend on each microbatch's membership: the port's batch is placed
pre-split, each microbatch the reference's slice).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.configs import registry as jreg
from repro.distributed import sharding as jsh
from repro.train import checkpoint as jck
from repro.train import data as jdata
from repro.train import train_loop as JT
from repro.train.optimizer import AdamWConfig as JAdamW
from _torch_mesh_worker import RankPool
from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

WORLD = 4
STEPS = 3
B, S = 4, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1)
# arch -> (microbatches, remat)
ARCHS = {"granite_3_8b": (2, True), "grok_1_314b": (2, False)}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD)
    yield p
    p.close()


def _reference(arch: str):
    """The reference's init_state flattened, its batches, and its
    sharded step's losses and flattened states."""
    nmb, remat = ARCHS[arch]
    cfg = jreg.get_config(arch).smoke()
    scfg = JT.StepConfig(microbatches=nmb, compute_dtype="float32",
                         remat=remat)
    opt = JAdamW(**OPT)
    state = JT.init_state(jax.random.PRNGKey(1), cfg, opt, scfg)
    state = jax.tree_util.tree_map(lambda x: jnp.array(x, x.dtype), state)
    flat0 = jck._flatten(state)
    ds = jdata.SyntheticLM(jdata.DataConfig(vocab=cfg.vocab, seq_len=S,
                                            global_batch=B, seed=0))
    batches = [{k: np.array(v) for k, v in ds.global_batch(i).items()}
               for i in range(STEPS)]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    base = JT.make_train_step(cfg, opt, scfg)

    def step(state, batch):
        with jsh.activate(mesh):
            return base(state, batch)
    jitted = jax.jit(step)
    losses, flats = [], []
    for b in batches:
        state, m = jitted(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        flats.append(jck._flatten(state))
    # GSPMD placed the step over the four devices
    assert max(len(x.sharding.device_set)
               for x in jax.tree_util.tree_leaves(state)) == 4
    return flat0, batches, losses, flats[-1], scfg


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_step_matches_reference_mesh(pool, arch):
    assert len(jax.devices()) >= 4
    flat0, batches, losses, want, scfg = _reference(arch)
    ranks = pool.run("train_on_mesh", arch=arch, flat0=flat0,
                     batches=batches,
                     scfg=dict(microbatches=scfg.microbatches,
                               compute_dtype="float32", remat=scfg.remat),
                     opt=OPT)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                                   atol=1e-5, err_msg=f"{arch} rank {r}")
        assert set(got["flat"]) == set(want)
        for k, w in want.items():
            w = np.asarray(w)
            assert got["flat"][k].dtype == w.dtype, k
            np.testing.assert_allclose(got["flat"][k], w, rtol=1e-4,
                                       atol=1e-4, err_msg=f"{arch} {k}")
