"""DNN interface (paper Section IV-B): whole-network descriptions in.

Takes a network name (or explicit layer list), emits the per-layer
workloads plus the dependency edges feeding overlap analysis, and runs the
whole-network optimization. Conv chains use identity coordinate maps; the
BERT encoder (Section VI) wires the attention dataflow, including the
sibling edges where QK consumes K-proj outputs as its stationary operand
and AV consumes V-proj outputs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from .arch import ArchSpec, dram_pim
from .overlap import (Edge, HeadFoldMap, HeadUnfoldMap, IdentityMap,
                      WeightMap)
from .search import NetworkResult, SearchConfig, optimize_network
from .workload import NETWORKS, LayerSpec, bert_encoder, get_network


@dataclasses.dataclass
class NetworkDesc:
    name: str
    layers: List[LayerSpec]
    edges: List[List[Edge]]     # per layer, producers it depends on


def _pool_between(prod: LayerSpec, cons: LayerSpec) -> int:
    """Infer an elementwise pooling factor between two conv layers from
    the spatial-shape mismatch (VGG pools, ResNet stem maxpool)."""
    need_h = (cons.P - 1) * cons.stride + cons.R - 2 * cons.pad
    if need_h <= 0 or prod.P % need_h:
        return 1
    return max(1, prod.P // need_h)


def chain_edges(layers: Sequence[LayerSpec]) -> List[List[Edge]]:
    """Sequential conv/FC chain: layer i consumes layer i-1 (pooling
    between blocks inferred from shapes)."""
    edges: List[List[Edge]] = [[]]
    for i in range(1, len(layers)):
        pool = _pool_between(layers[i - 1], layers[i])
        edges.append([Edge(i - 1, IdentityMap(pool=pool))])
    return edges


def _edge(layers, j, i) -> Edge:
    return Edge(j, IdentityMap(pool=_pool_between(layers[j], layers[i])))


def resnet18_edges(layers: Sequence[LayerSpec]) -> List[List[Edge]]:
    """Residual wiring: downsample convs consume the stage input; the
    block after an add consumes both the main path and the skip path
    (paper Section IV-J treats skip layers as latency-neutral, but their
    outputs still gate the next block's inputs)."""
    name_idx = {l.name: j for j, l in enumerate(layers)}
    edges: List[List[Edge]] = []
    for i, l in enumerate(layers):
        n = l.name
        if n == "conv1":
            edges.append([])
        elif n.endswith("b0c1") or n.endswith("b0ds"):
            # stage entry: consumes previous stage's block output
            prev = i - 1 if n.endswith("b0c1") else i - 3
            while layers[prev].name.endswith("ds"):
                prev -= 1
            edges.append([_edge(layers, prev, i)])
        elif n.endswith("b1c1"):
            # after the add: main (b0c2) + skip (b0ds if present)
            es = [_edge(layers, name_idx[n[:-4] + "b0c2"], i)]
            ds = n[:-4] + "b0ds"
            if ds in name_idx:
                es.append(_edge(layers, name_idx[ds], i))
            edges.append(es)
        else:  # c2-of-block: consumes its c1
            edges.append([_edge(layers, i - 1, i)])
    return edges


def describe(name: str, **kw) -> NetworkDesc:
    """Network name (or zoo scenario string) -> ``NetworkDesc``.

    Core names (``resnet18``/``vgg16``/``resnet50``/``bert_encoder``)
    resolve here; anything else is handed to the LLM lowering layer
    (``repro_torch.workloads``), whose scenario grammar is
    ``<arch>[:phase][@length][xblocks]``. Keyword arguments are only
    legal where something consumes them (bert shapes, scenario shapes) —
    unconsumed kwargs raise instead of silently returning the default
    network."""
    if name == "bert_encoder":
        return describe_bert(**kw)
    if name in NETWORKS:
        if kw:
            raise TypeError(
                f"describe({name!r}) takes no keyword arguments (got "
                f"{sorted(kw)}); only bert_encoder and zoo scenarios "
                "are parameterizable")
        layers = get_network(name)
        if name == "resnet18":
            return NetworkDesc(name=name, layers=layers,
                               edges=resnet18_edges(layers))
        return NetworkDesc(name=name, layers=layers,
                           edges=chain_edges(layers))
    # not a core network: the LLM workload lowering layer (lazy import —
    # repro_torch.workloads pulls in the config registry and ModelConfig)
    from ..workloads import describe_scenario
    return describe_scenario(name, **kw)


def known_network(name: str) -> bool:
    """Cheap existence check for request validation: True iff ``name``
    is a core network or parses as a zoo scenario. No layers are built
    (an unknown name must be rejectable without paying a lowering)."""
    if name == "bert_encoder" or name in NETWORKS:
        return True
    try:
        from ..workloads import is_scenario_name
    except ImportError:          # zoo deps unavailable in this build
        return False
    return is_scenario_name(name)


def describe_bert(seq: int = 512, d_model: int = 768, heads: int = 12,
                  d_ff: int = 3072) -> NetworkDesc:
    layers = bert_encoder(seq, d_model, heads, d_ff)
    hd = d_model // heads
    # layer order: q(0) k(1) v(2) qk(3) av(4) out(5) ffn1(6) ffn2(7)
    edges: List[List[Edge]] = [
        [],                                    # q_proj  <- embeddings
        [],                                    # k_proj  <- embeddings
        [],                                    # v_proj  <- embeddings
        [Edge(0, HeadFoldMap(seq, hd)),        # qk: input = Q
         Edge(1, WeightMap(seq, hd, "qk_weight"))],   # stationary = K^T
        [Edge(3, IdentityMap()),               # av: input = scores
         Edge(2, WeightMap(seq, hd, "av_weight"))],   # stationary = V
        [Edge(4, HeadUnfoldMap(seq, hd))],     # out_proj
        [Edge(5, IdentityMap())],              # ffn1
        [Edge(6, IdentityMap())],              # ffn2
    ]
    return NetworkDesc(name="bert_encoder", layers=layers, edges=edges)


def optimize(name: str, arch: Optional[ArchSpec] = None,
             cfg: Optional[SearchConfig] = None) -> NetworkResult:
    """One-call whole-network optimization (the Fig 5 flow)."""
    desc = describe(name)
    return optimize_network(desc.layers, desc.edges,
                            arch or dram_pim(), cfg or SearchConfig())
