"""Fast-OverlaPIM core: the paper's mapping-optimization framework."""
from .arch import ArchSpec, HBMTiming, Level, dram_pim, reram_pim, tpu_spatial
from .dataspace import (DataSpaces, generate_analytical, generate_exhaustive,
                        locate_finish, locate_finish_exhaustive, rect_bounds)
from .engine import OverlapEngine, optimize_network_engine
from .interface import (NetworkDesc, chain_edges, describe, known_network,
                        optimize)
from .mapping import Loop, Mapping, divisors, heuristic_mapping, \
    random_mapping
from .overlap import (CoordMap, Edge, FullMap, HeadFoldMap, HeadUnfoldMap,
                      IdentityMap, WeightMap, consumer_tiles,
                      max_step_in_rect, overlapped_end,
                      ready_steps_analytical, ready_steps_exhaustive,
                      schedule_with_ready, stream_tail_fraction)
from .perf_model import (LayerPerf, PerfCache, analyze, arch_area_proxy,
                         arch_power_proxy, move_energy_pj, step_latency_ns)
from .search import (MODES, OBJECTIVES, STRATEGIES, LayerResult,
                     NetworkResult, SearchConfig, combine_objective,
                     evaluate_chain, optimize_network)
from .transform import TransformResult, transform_schedule
from .workload import (DIMS, OUTPUT_DIMS, REDUCTION_DIMS, LayerSpec,
                       bert_encoder, conv, get_network, matmul, resnet18,
                       resnet50, vgg16)

__all__ = [n for n in dir() if not n.startswith("_")]
