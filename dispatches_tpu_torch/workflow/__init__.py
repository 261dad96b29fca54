"""Workflow layer — the analogue of `dispatches/workflow/` plus the
reference's run-script/config/post-processing utilities (the port's
`dispatches-tpu-torch` entry points are in `runners.py`)."""

from .options import SimulationOptions
from .postprocess import (
    calculate_npv,
    gen_outputs,
    read_results_csv,
    results_to_csv,
    summarize_h2_revenue,
    summarize_revenue,
)
from .rts_gmlc import download
from .workflow import Dataset, DatasetFactory, ManagedWorkflow
