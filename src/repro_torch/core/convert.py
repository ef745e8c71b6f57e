"""State carried across from the reference package, as NumPy arrays.

A ``repro`` ``BuildResult`` exported with ``np.asarray`` on its arrays
(``g.ids``, ``g.dist``) plus its plain fields becomes the port's
``BuildResult`` (an NSG one the port's ``NSGBuildResult``, an HNSW one
with its layers, levels, entry and top the port's ``HNSWBuildResult``),
a ``repro`` ``ShardedGraph`` the port's, and a ``repro`` ``RetrievalIndex``
(sharded or not) the port's, so a graph, a partition or an index built by
either package can be searched by the other.  A
``repro`` LM parameter tree becomes the port's ``models.model.LM``, and a
``repro`` GP surrogate the port's ``tuner.gp.GPState``.
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
                               shards=None,
                               device: "str | torch.device" = "cuda"
                               ) -> RetrievalIndex:
    """A reference index's arrays -> the port's RetrievalIndex.

    ``params`` is any object with L, M, alpha; ``quant`` the reference's
    ``QuantizedData`` (or any (codes, scale, norms) triple), carried over
    as it is, never re-quantized.  A sharded index passes its
    ``ShardedGraph``'s fields as ``shards`` (``sharded_graph_from_numpy``)
    with ``graph_ids`` and ``search_keys`` None."""
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
                sharded_graph_from_numpy(shards, dev)))


def lm_params_from_numpy(tree: dict, cfg: ArchConfig,
                         device: "str | torch.device" = "cuda",
                         dtype: torch.dtype = torch.float32
                         ) -> "model_lib.LM":
    """A reference ``init_params`` tree (NumPy leaves) -> the port's LM.

    The reference stacks each period group's sublayers into (n_groups, ...)
    leaves under ``blocks/sub{j}``; leaf ``[g]`` becomes layer
    ``g * period + j``.  Every weight keeps its layout; values are cast to
    ``dtype``.  The tree must hold exactly the port's parameters."""
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

    for pname, param in model.embed.items():
        put(f"embed/{pname}", param, tree["embed"][pname])
    put("final_norm/scale", model.final_norm["scale"],
        tree["final_norm"]["scale"])
    period = cfg.period
    for i, layer in enumerate(model.layers):
        g, j = divmod(i, period)
        sub = tree["blocks"][f"sub{j}"]
        for mod, params in layer.items():
            for pname, param in params.items():
                put(f"blocks/sub{j}/{mod}/{pname}", param,
                    sub[mod][pname][g])
    want = {f"{top}/{k}" for top in ("embed", "final_norm")
            for k in tree[top]}
    want |= {f"blocks/{s}/{m}/{k}" for s, sub in tree["blocks"].items()
             for m, leaves in sub.items() for k in leaves}
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
