"""Catchup pipeline (reference: src/catchup)."""

from .apply_buckets import ApplyBucketsWork
from .catchup_work import (CATCHUP_COMPLETE, CATCHUP_MINIMAL,
                           ApplyCheckpointWork, CatchupConfiguration,
                           CatchupWork, GetHistoryArchiveStateWork,
                           GetRemoteFileWork)
from .pipeline import PipelineStats, StreamingCatchupWork

__all__ = ["CatchupWork", "CatchupConfiguration", "ApplyCheckpointWork",
           "ApplyBucketsWork", "GetRemoteFileWork",
           "GetHistoryArchiveStateWork", "StreamingCatchupWork",
           "PipelineStats", "CATCHUP_COMPLETE", "CATCHUP_MINIMAL"]
