"""Market-surrogate stack (port of `dispatches_tpu/surrogates/`): the
analogue of `dispatches/workflow/train_market_surrogates/dynamic/` +
`util/surrogates.py`."""

from .clustering import KMeansResult, TimeSeriesClustering, kmeans
from .data import SimulationData, read_csv_matrix
from .embed import (
    AlamoSurrogate,
    smooth_nonneg,
    surrogate_fn,
    train_surrogate_model,
)
from .train import SurrogateMLP, TrainedSurrogate, TrainNNSurrogates, train_surrogate
