"""Architecture design-space exploration (DSE) on the batched engine.

Co-searches PIM architecture configurations (``core.arch`` factories)
jointly with overlap-driven mapping search: the NicePIM/PIMSYN-style
"best (arch, mapping) pair" capability on top of Fast-OverlaPIM's fast
overlap analysis. See DESIGN.md Section 8.
"""
from .distrib import (DistribConfig, run_coordinator, run_distributed,
                      worker_loop)
from .driver import (execute_sweep, frontier_points, journal_path_for,
                     journal_template, network_token, objective_tag,
                     shared_dir_for, sweep_summary)
from .explore import (DSEConfig, DSEResult, EXPLORERS, ProposalStream,
                      evaluate_point, network_energy_pj, point_key,
                      proposal_stream, record_edp, run_dse)
from .pareto import (DEFAULT_OBJECTIVES, FrontierPoint, ParetoFrontier,
                     dominates)
from .persist import (FileBackend, JournalBackend, RunJournal,
                      SharedDirBackend, content_key)
from .report import (best_arch_table, frontier_table, summarize,
                     sweep_networks)
from .space import (DesignPoint, ParamSpace, SPACES, dram_space, get_space,
                    reram_space, tpu_space)

__all__ = [n for n in dir() if not n.startswith("_")]
