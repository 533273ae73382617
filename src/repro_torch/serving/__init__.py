from .engine import ServingEngine, EngineConfig
from .api import Backend, RequestHandle, Server, WatchdogConfig
