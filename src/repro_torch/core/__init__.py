from .hardware import HardwareProfile, A100_SXM4_40G, TPU_V5E, PROFILES
from .types import (Request, RequestState, SamplingParams, SLOConfig,
                    StateEvent, TokenEvent)
from .report import (ReplicaReport, RequestReport, ServingReport,
                     build_report, slo_pass_metrics)
from .models import QuadraticLatencyModel, CubicPowerModel, TPSFreqTable
from .router import LengthRouter, make_router, SINGLE_QUEUE
from .prefill_optimizer import PrefillOptimizer, deadline_from_queue
from .decode_controller import (DualLoopController, DecodeControllerConfig,
                                MaxFreqController, FixedFreqController)
from .telemetry import TPSMeter, TBTMeter, OccupancyMeter, SlidingWindow
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      parse_prometheus, quantile_from_buckets,
                      read_timeline_jsonl)
from .tracing import DvfsDecision, Span, Tracer, read_jsonl as read_trace_jsonl
from .attribution import (CounterfactualPricer, EnergyLedger, LedgerCarry,
                          verify_conservation)
from .alerts import Alert, AlertEngine, AlertRule
