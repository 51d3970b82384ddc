"""Observability of the port: stdout tee logger, experiment metric sinks
(W&B when available, JSONL always), image dumps, profiler hooks."""
from .loggers import Logger
from .profiler import StepTimer, profile_trace
from .sinks import ExperimentLogger, JsonlSink, WandbSink
from .visualiser import (
    load_model_from_weights,
    process_image_using_model,
    save_from_array,
)

__all__ = [
    "ExperimentLogger",
    "JsonlSink",
    "Logger",
    "StepTimer",
    "WandbSink",
    "load_model_from_weights",
    "process_image_using_model",
    "profile_trace",
    "save_from_array",
]
