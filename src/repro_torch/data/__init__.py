from .pipeline import DataConfig, Pipeline, make_batch
