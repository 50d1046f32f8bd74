"""LLM workload lowering: the model zoo as overlap-searchable networks.

``repro_torch.configs`` defines ten LM architectures (run as PyTorch
programs by ``repro_torch.models``); ``repro_torch.core`` searches PIM
mappings over 7D loop-nest networks. This package is the bridge: ``lower`` turns one ``ModelConfig``
block into ``LayerSpec`` chains + dependency ``Edge``s, and ``scenarios``
names the interesting shapes (``deepseek_moe_16b:prefill@2048``,
``mamba2_780m:decode@1``, smoke variants) so every existing entry point —
``describe``/``get_network``, ``run.py dse --network``, a
``MappingRequest`` — accepts the whole zoo unchanged. Conventions are
specified in DESIGN.md Section 15.
"""
from .lowering import (NetBuilder, PHASES, lower, moe_capacity)
from .scenarios import (DEFAULT_DECODE_KV, DEFAULT_PREFILL_SEQ,
                        SMOKE_DECODE_KV, SMOKE_PREFILL_SEQ, Scenario,
                        describe_scenario, is_scenario_name,
                        list_scenarios, lower_scenario, parse_scenario,
                        scenario_layers)

__all__ = [n for n in dir() if not n.startswith("_")]
