"""How far fp32 runs of the xLSTM smoke model stray from a float64 run.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/witness_xlstm_conditioning.py

The reference's fp32 forward (``repro``), the port's fp32 forward and the
port's forward in float64 on the same converted weights, at S = 12 (one
mLSTM chunk) and S = 140 (past one), for a few init and token seeds.
Prints, per case, the largest absolute difference of the logits between
each pair: the port against the reference, and each fp32 run against
float64.  It is the yardstick of ``tests/test_torch_xlstm.py``'s
whole-model tolerance: the two fp32 runs can agree no better than each
agrees with float64.  CPU only, ~1 min.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.models import model as JM
from repro_torch.configs import registry as treg
from repro_torch.core import convert
from repro_torch.models import model as TM


def main() -> None:
    jcfg = jreg.get_config("xlstm_350m").smoke()
    tcfg = treg.get_config("xlstm_350m").smoke()
    for seed in (1, 2, 3, 4):
        params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
        tree = jax.tree_util.tree_map(np.asarray, params)
        model = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
        m64 = copy.deepcopy(model).double()
        for s in (12, 140):
            toks = np.random.default_rng(seed).integers(0, jcfg.vocab,
                                                        (2, s))
            ref = np.asarray(JM.forward(params, jcfg, jnp.asarray(toks),
                                        remat=False))
            port = TM.forward(model, torch.from_numpy(toks)).numpy()
            f64 = TM.forward(m64, torch.from_numpy(toks)).numpy()
            print(f"seed {seed} S {s:3d}: port-ref "
                  f"{np.abs(port - ref).max():.3e}  ref-f64 "
                  f"{np.abs(ref - f64).max():.3e}  port-f64 "
                  f"{np.abs(port - f64).max():.3e}  |logit| max "
                  f"{np.abs(f64).max():.1f}", flush=True)


if __name__ == "__main__":
    main()
