from qmf_tpu_torch.ops import als_ops  # noqa: F401
from qmf_tpu_torch.ops.packing import Bucket, pack_buckets, packed_stats  # noqa: F401
