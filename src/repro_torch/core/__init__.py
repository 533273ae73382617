from .hardware import HardwareProfile, A100_SXM4_40G, TPU_V5E, PROFILES
from .types import (Request, RequestState, SamplingParams, SLOConfig,
                    StateEvent, TokenEvent)
from .report import (ReplicaReport, RequestReport, ServingReport,
                     build_report, slo_pass_metrics)
from .models import QuadraticLatencyModel, CubicPowerModel, TPSFreqTable
from .router import LengthRouter, make_router, SINGLE_QUEUE
from .decode_controller import (DualLoopController, DecodeControllerConfig,
                                MaxFreqController, FixedFreqController)
from .telemetry import TPSMeter, TBTMeter, OccupancyMeter, SlidingWindow
