"""Data of the port: songs-sim for the DMMC settings, and the training
data pipeline with diverse batch selection.

Reference: ``repro/data/`` (``pipeline.py``) and the songs-like
generator of ``benchmarks/common.py``.
"""
from .pipeline import DataConfig, Pipeline, diverse_pick
from .songs import SONGS_DIM, SONGS_GENRES, SONGS_N, SONGS_RANK, songs_sim

__all__ = ["DataConfig", "Pipeline", "SONGS_DIM", "SONGS_GENRES", "SONGS_N",
           "SONGS_RANK", "diverse_pick", "songs_sim"]
