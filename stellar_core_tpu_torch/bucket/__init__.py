"""Bucket LSM storage (reference: src/bucket/).

- bucket: one sorted XDR flat file with the INIT/LIVE/DEAD lifecycle and
  deterministic merges (Bucket.cpp:252-453)
- bucket_list: the 11-level curr/snap structure with half-level spill
  cadence and background merges (BucketList.cpp, FutureBucket.h)
- manager: content-hash dedup bucket directory + refcount GC
  (BucketManagerImpl)
"""

from .bucket import Bucket, merge_buckets, EMPTY_HASH
from .bucket_list import BucketList, BucketLevel, FutureBucket, NUM_LEVELS
from .manager import BucketManager

__all__ = ["Bucket", "merge_buckets", "EMPTY_HASH", "BucketList",
           "BucketLevel", "FutureBucket", "NUM_LEVELS", "BucketManager"]
