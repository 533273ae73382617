from .plant import PlantModel
from .engine import ServingSimulator, NodeConfig, SimResult
from .profiling import (profile_prefill_latency, profile_power,
                        profile_decode_table)
from .replay import (ReplayConfig, replay, build_simulator, compute_metrics,
                     Metrics, make_plant_fn, slo_pass_metrics, GOVERNORS)
