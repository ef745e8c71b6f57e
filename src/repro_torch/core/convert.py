"""State carried across from the reference package, as NumPy arrays.

A ``repro`` ``BuildResult`` exported with ``np.asarray`` on its arrays
(``g.ids``, ``g.dist``) plus its plain fields becomes the port's
``BuildResult`` (an NSG one the port's ``NSGBuildResult``, an HNSW one
with its layers, levels, entry and top the port's ``HNSWBuildResult``),
a ``repro`` ``ShardedGraph`` the port's, and a ``repro`` ``RetrievalIndex``
(sharded or not) the port's, so a graph, a partition or an index built by
either package can be searched by the other.  A
``repro`` LM parameter tree becomes the port's ``models.model.LM``, a
``repro`` ``TrainState`` (flattened as its checkpoints flatten it) the
port's ``train.train_loop.TrainState`` and back, and a ``repro`` GP
surrogate the port's ``tuner.gp.GPState``.
Nothing here imports the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import metric as metric_lib
from repro_torch.core.counters import BuildCounters
from repro_torch.core import graph as graph_lib
from repro_torch.core.graph import MultiGraph
from repro_torch.core.hnsw import HNSWBuildResult, HNSWGraphs
from repro_torch.core.nsg import NSGBuildResult
from repro_torch.core.tuner import gp as gplib
from repro_torch.core.vamana import BuildResult, VamanaParams
from repro_torch.models import model as model_lib
from repro_torch.serve.retrieval import RetrievalIndex
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import compression
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_loop


def graph_from_numpy(ids: np.ndarray, dist: np.ndarray,
                     device: "str | torch.device" = "cuda") -> MultiGraph:
    """int32[m, n, M_max] ids + float32 edge lengths -> MultiGraph."""
    dev = resolve_device(device)
    ids = np.asarray(ids)
    dist = np.asarray(dist)
    if ids.ndim != 3 or ids.shape != dist.shape:
        raise ValueError(f"expected matching (m, n, M_max) arrays, got "
                         f"{ids.shape} and {dist.shape}")
    return MultiGraph(
        ids=torch.as_tensor(ids.astype(np.int32), device=dev),
        dist=torch.as_tensor(dist.astype(np.float32), device=dev))


def _counters(counters: dict) -> BuildCounters:
    """``BuildCounters.as_dict()`` -> BuildCounters (derived totals
    ignored)."""
    return BuildCounters(**{f: int(counters.get(f, 0)) for f in
                            ("search_base", "search", "prune_base", "prune",
                             "init_base", "init", "connect")})


def build_result_from_numpy(ids, dist, entry: int, counters: dict, params,
                            metric: str = "l2",
                            device: "str | torch.device" = "cuda"
                            ) -> BuildResult:
    """A reference Vamana build's arrays and fields -> the port's
    BuildResult.

    ``counters`` is ``BuildCounters.as_dict()``; ``params`` the build's
    parameter list."""
    return BuildResult(g=graph_from_numpy(ids, dist, device),
                       entry=int(entry), counters=_counters(counters),
                       params=list(params), metric=metric)


def nsg_result_from_numpy(ids, dist, entry: int, counters: dict, params,
                          metric: str = "l2",
                          device: "str | torch.device" = "cuda"
                          ) -> NSGBuildResult:
    """A reference NSG build's arrays and fields -> the port's
    NSGBuildResult (the same fields as a Vamana build's)."""
    res = build_result_from_numpy(ids, dist, entry, counters, params,
                                  metric, device)
    return NSGBuildResult(g=res.g, entry=res.entry, counters=res.counters,
                          params=res.params, metric=res.metric)


def hnsw_result_from_numpy(layer_ids, layer_dist, levels, entry: int,
                           top: int, counters: dict, params,
                           metric: str = "l2",
                           device: "str | torch.device" = "cuda"
                           ) -> HNSWBuildResult:
    """A reference HNSW build's layers int32 / float32[n_layers, m, n,
    M_max], levels, entry and top layer -> the port's HNSWBuildResult."""
    dev = resolve_device(device)
    layer_ids = np.asarray(layer_ids)
    layer_dist = np.asarray(layer_dist)
    if layer_ids.ndim != 4 or layer_ids.shape != layer_dist.shape:
        raise ValueError(f"expected matching (n_layers, m, n, M_max) arrays, "
                         f"got {layer_ids.shape} and {layer_dist.shape}")
    g = HNSWGraphs(
        layer_ids=as_tensor(layer_ids, dev, torch.int32),
        layer_dist=as_tensor(layer_dist, dev, torch.float32),
        levels=np.asarray(levels, np.int32), entry=int(entry), top=int(top))
    return HNSWBuildResult(g=g, counters=_counters(counters),
                           params=list(params), metric=metric)


_SHARDED_DTYPES = dict(ids=torch.int32, data=torch.float32,
                       global_ids=torch.int32, entries=torch.int32,
                       counts=torch.int32, centroids=torch.float32,
                       flat_ids=torch.int32, qcodes=torch.int8,
                       qscale=torch.float32, qnorms=torch.float32)


def sharded_graph_from_numpy(fields: dict,
                             device: "str | torch.device" = "cuda"
                             ) -> graph_lib.ShardedGraph:
    """A reference ``ShardedGraph``'s arrays (``{name: np.asarray(value)}``
    over its fields, None where the field is None) -> the port's, on
    ``device``.  ``flat_ids`` is computed from ``ids`` when the reference
    graph has none; the optional fields may be left out."""
    dev = resolve_device(device)
    missing = {"ids", "data", "global_ids", "entries", "counts"} - set(
        fields)
    if missing:
        raise ValueError(f"sharded graph without {sorted(missing)}")
    sg = graph_lib.ShardedGraph(**{
        f: as_tensor(np.array(fields[f]), dev, dt)
        for f, dt in _SHARDED_DTYPES.items() if fields.get(f) is not None})
    if sg.flat_ids is None:
        sg.flat_ids = graph_lib.flat_adjacency(sg.ids)
    return sg


def retrieval_index_from_numpy(graph_ids, keys, values, search_keys,
                               entry: int, params, metric: str, *,
                               quantize: str = "none", quant=None,
                               shards=None, provenance: dict | None = None,
                               device: "str | torch.device" = "cuda"
                               ) -> RetrievalIndex:
    """A reference index's arrays -> the port's RetrievalIndex.

    ``params`` is any object with L, M, alpha; ``quant`` the reference's
    ``QuantizedData`` (or any (codes, scale, norms) triple), carried over
    as it is, never re-quantized.  A sharded index passes its
    ``ShardedGraph``'s fields as ``shards`` (``sharded_graph_from_numpy``)
    with ``graph_ids`` and ``search_keys`` None.  ``provenance`` is the
    build knobs' record (``serve/resilience.load_index`` reads it from a
    snapshot's manifest)."""
    if quantize not in metric_lib.QUANTIZE_MODES:
        raise ValueError(
            f"quantize {quantize!r} not in {metric_lib.QUANTIZE_MODES}")
    dev = resolve_device(device)
    f32 = torch.float32
    if quant is not None:
        codes, scale, norms = quant
        quant = metric_lib.QuantizedData(
            as_tensor(np.array(codes), dev, torch.int8),
            as_tensor(np.array(scale), dev, f32),
            as_tensor(np.array(norms), dev, f32))
    return RetrievalIndex(
        graph_ids=(None if graph_ids is None else
                   as_tensor(np.array(graph_ids), dev, torch.int32)),
        keys=as_tensor(np.array(keys), dev, f32),
        values=as_tensor(np.array(values), dev, f32),
        search_keys=(None if search_keys is None else
                     as_tensor(np.array(search_keys), dev, f32)),
        entry=int(entry), params=VamanaParams(params.L, params.M,
                                              params.alpha),
        metric=metric, quantize=quantize, quant=quant,
        shards=(None if shards is None else
                sharded_graph_from_numpy(shards, dev)),
        provenance=provenance)


def lm_params_from_numpy(tree: dict, cfg: ArchConfig,
                         device: "str | torch.device" = "cuda",
                         dtype: torch.dtype = torch.float32
                         ) -> "model_lib.LM":
    """A reference ``init_params`` tree (NumPy leaves) -> the port's LM.

    The reference stacks each period group's sublayers into (n_groups, ...)
    leaves under ``blocks/sub{j}``; leaf ``[g]`` becomes layer
    ``g * period + j``.  An encoder-decoder's stacked ``encoder`` leaves
    ``[l]`` become encoder layer l, beside ``enc_norm``.  Every weight
    keeps its layout (attention, Mamba, mLSTM, sLSTM, MoE, dense and
    cross-attention leaves alike); values are cast to ``dtype``.  The tree
    must hold exactly the port's parameters: every reference leaf lands on
    one port parameter."""
    dev = resolve_device(device)
    model = model_lib.init_params(cfg, None, device=dev, dtype=dtype)
    done: set[str] = set()

    def put(name: str, param: torch.Tensor, arr) -> None:
        a = np.array(arr, dtype=np.float32)
        if tuple(a.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {a.shape}, port "
                             f"shape {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(a))
        done.add(name)

    def stacked(top: str, sub: dict, layer, i: int) -> None:
        for mod, params in layer.items():
            for pname, param in params.items():
                put(f"{top}/{mod}/{pname}", param, sub[mod][pname][i])

    def leaves(node, prefix: str = ""):
        if not isinstance(node, dict):
            return {prefix[:-1]}
        return set().union(*(leaves(v, f"{prefix}{k}/")
                             for k, v in node.items()))

    for pname, param in model.embed.items():
        put(f"embed/{pname}", param, tree["embed"][pname])
    put("final_norm/scale", model.final_norm["scale"],
        tree["final_norm"]["scale"])
    for i, layer in enumerate(model.layers):
        g, j = divmod(i, cfg.period)
        stacked(f"blocks/sub{j}", tree["blocks"][f"sub{j}"], layer, g)
    if model.encoder is not None:
        for i, layer in enumerate(model.encoder):
            stacked("encoder", tree["encoder"], layer, i)
        put("enc_norm/scale", model.enc_norm["scale"],
            tree["enc_norm"]["scale"])
    want = leaves(tree)
    if want != done:
        raise ValueError(f"reference leaves without a port parameter: "
                         f"{sorted(want - done)}")
    return model


def gp_state_from_numpy(fields: dict,
                        device: "str | torch.device" = "cuda"
                        ) -> "gplib.GPState":
    """A reference ``GPState``'s arrays (``{name: np.asarray(value)}`` over
    its fields, e.g. from ``vars(state)``) -> the port's GPState, float32
    on ``device``, so the port's ``predict``, ``sample`` and EHVI
    functions run on the reference's surrogate."""
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(gplib.GPState)]
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"GP state without {sorted(missing)}")
    return gplib.GPState(**{f: as_tensor(np.asarray(fields[f]), dev,
                                         torch.float32) for f in names})


def train_state_from_numpy(flat: dict, cfg: ArchConfig,
                           device: "str | torch.device" = "cuda"
                           ) -> "train_loop.TrainState":
    """A reference ``TrainState`` flattened as its checkpoints are
    (``repro.train.checkpoint._flatten``: ``.params/blocks/sub0/attn/wq``,
    ``.opt/.step``, ``.opt/.mu/...``, ``.opt/.nu/...``, ``.ef/.residual/...``
    with compression, ``.step``) -> the port's TrainState on ``device``.

    The leaves stay the reference's (stacked over period groups), every
    array keeps its dtype and values; ``cfg`` checks that the parameters
    are exactly the ones the port's model for it has."""
    dev = resolve_device(device)

    def sub(prefix: str) -> dict:
        return {k[len(prefix):]: torch.from_numpy(np.array(v)).to(dev)
                for k, v in flat.items() if k.startswith(prefix)}

    params = sub(".params/")
    want = model_lib.leaf_shapes(cfg)
    if set(params) != set(want):
        raise ValueError(f"{cfg.name}: reference leaves "
                         f"{sorted(set(params) ^ set(want))} do not match "
                         f"the port's parameters")
    for k, shape in want.items():
        if tuple(params[k].shape) != shape:
            raise ValueError(f"{cfg.name}: reference leaf {k} is "
                             f"{tuple(params[k].shape)}, the port's {shape}")
    for k in (".opt/.step", ".step"):
        if k not in flat:
            raise KeyError(f"train state without {k}")
    opt = opt_lib.AdamWState(
        step=torch.from_numpy(np.array(flat[".opt/.step"])).to(dev),
        mu=dict(sorted(sub(".opt/.mu/").items())),
        nu=dict(sorted(sub(".opt/.nu/").items())))
    residual = sub(".ef/.residual/")
    ef = (compression.EFState(residual=dict(sorted(residual.items())))
          if residual else None)
    return train_loop.TrainState(
        params=dict(sorted(params.items())), opt=opt, ef=ef,
        step=torch.from_numpy(np.array(flat[".step"])).to(dev))


def train_state_to_numpy(state: "train_loop.TrainState") -> dict:
    """The port's TrainState -> the reference's flattened form (the keys
    and host arrays its checkpoints hold), for
    ``jax.tree_util.tree_unflatten`` or a reference ``restore``."""
    return ckpt_lib._flatten(state)
