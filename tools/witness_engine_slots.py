#!/usr/bin/env python3
"""The serving engine's slot overwrite, in the JAX reference and in the
PyTorch port side by side.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/witness_engine_slots.py \
        [--arch gemma2_9b] [--lengths 10 2] [--max-new 8]

``ServeEngine._admit`` prefills a prompt token by token through
``decode_step`` with the other slots' tokens set to 0, and every decode
call writes its K/V row at the one shared ``pos`` for every slot.  So
admitting a second request overwrites the first slot's prompt rows with
the K/V of token 0.  This witness runs the arch's smoke config with the
reference's random weights (the port gets the same weights through
``convert.lm_params_from_numpy``), admits prompts of ``--lengths`` into a
2-slot engine and the first prompt alone into a 1-slot engine, and prints
one JSON line per package: the largest difference of slot 0's cached keys
per prompt row over all layers, the largest difference of slot 0's logits
after the next tick, and both engines' greedy tokens.  The last line is
the largest gap between the two packages' differences.  Both packages run
on the CPU: the reference on JAX's CPU backend, the port with
``device="cpu"``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def _reference(params, cfg, prompts, slots, max_new):
    import jax
    from repro.serve import engine
    eng = engine.ServeEngine(params, cfg, batch_slots=slots, max_seq=64)
    reqs = [engine.Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts[:slots])]
    for r in reqs:
        eng.submit(r)
    eng._admit()
    keys = np.stack([np.asarray(eng.cache[f"sub{j}"]["k"][g][0])
                     for g in range(cfg.n_groups)
                     for j in range(cfg.period)])
    eng.step()
    first = np.asarray(jax.device_get(reqs[0]._last_logits), np.float32)
    while any(s is not None for s in eng.slots):
        eng.step()
    return keys, first, reqs[0].out


def _port(tree, prompts, slots, max_new, arch):
    import torch
    from repro_torch.configs import registry
    from repro_torch.core import convert
    from repro_torch.serve import engine
    cfg = registry.get_config(arch).smoke()
    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    eng = engine.ServeEngine(model, cfg, batch_slots=slots, max_seq=64)
    reqs = [engine.Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts[:slots])]
    for r in reqs:
        eng.submit(r)
    eng._admit()
    keys = torch.stack([c["k"][0] for c in eng.cache]).numpy()
    eng.step()
    first = np.asarray(reqs[0]._last_logits, np.float32)
    while any(s is not None for s in eng.slots):
        eng.step()
    return keys, first, reqs[0].out


def _diffs(one, two, n_rows):
    (k1, l1, t1), (k2, l2, t2) = one, two
    rows = [float(np.abs(k2[:, r] - k1[:, r]).max()) for r in range(n_rows)]
    return dict(key_row_diff=rows, logit_diff=float(np.abs(l2 - l1).max()),
                tokens_1slot=[int(t) for t in t1],
                tokens_2slot=[int(t) for t in t2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2_9b")
    ap.add_argument("--lengths", type=int, nargs=2, default=[10, 2])
    ap.add_argument("--max-new", type=int, default=8)
    args = ap.parse_args()
    import jax
    from repro.configs import registry
    from repro.models import model
    cfg = registry.get_config(args.arch).smoke()
    params = model.init_params(jax.random.PRNGKey(3), cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    r = np.random.default_rng(0)
    prompts = [r.integers(0, cfg.vocab, n).astype(np.int32)
               for n in args.lengths]
    n_rows = args.lengths[0]
    out = {}
    for name, run in (
            ("repro", lambda s: _reference(params, cfg, prompts, s,
                                           args.max_new)),
            ("repro_torch", lambda s: _port(tree, prompts, s, args.max_new,
                                            args.arch))):
        out[name] = _diffs(run(1), run(2), n_rows)
        print(json.dumps(dict(package=name, arch=cfg.name,
                              lengths=args.lengths, **out[name])),
              flush=True)
    a, b = out["repro"], out["repro_torch"]
    gap = max([abs(x - y) for x, y in zip(a["key_row_diff"],
                                          b["key_row_diff"])]
              + [abs(a["logit_diff"] - b["logit_diff"])])
    print(json.dumps(dict(max_gap_between_packages=gap,
                          same_tokens=a["tokens_2slot"] == b["tokens_2slot"]
                          and a["tokens_1slot"] == b["tokens_1slot"])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
