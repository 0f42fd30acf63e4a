"""Device-mesh parallelism (SURVEY.md §2.5 mapping)."""

from rayuela_tpu.parallel.chainq_sharded import (sharded_viterbi_encode,
                                                 train_chainq_sharded)
from rayuela_tpu.parallel.launch import (global_mesh,
                                         host_local_to_global,
                                         initialize)
from rayuela_tpu.parallel.lsq_sharded import (make_sr_train_step,
                                              sharded_encoding_icm,
                                              train_lsq_family_sharded)
from rayuela_tpu.parallel.mesh import (make_mesh, pq_lloyd_step_sharded,
                                       replicate, shard_data,
                                       sharded_scan_topk, sharded_search,
                                       sharded_search_codes,
                                       sharded_search_exact)

__all__ = ["global_mesh", "host_local_to_global", "initialize",
           "make_mesh", "make_sr_train_step", "pq_lloyd_step_sharded",
           "replicate", "shard_data", "sharded_encoding_icm",
           "sharded_scan_topk", "sharded_search", "sharded_search_codes",
           "sharded_search_exact", "sharded_viterbi_encode",
           "train_chainq_sharded", "train_lsq_family_sharded"]
