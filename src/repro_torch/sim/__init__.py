from .plant import PlantModel
from .profiling import (profile_prefill_latency, profile_power,
                        profile_decode_table)
