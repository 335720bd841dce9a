"""ray_tpu_torch.train: distributed training orchestration (Ray Train parity).

Port of `ray_tpu/train/`: TorchTrainer fans a user
`train_loop_per_worker` out to a WorkerGroup of actors, joins them into
one `torch.distributed` process group (TorchBackend), streams report()
results back, manages checkpoints with retention, and restarts the whole
group from the latest checkpoint on failure, or, with
`ScalingConfig(elastic=...)`, reshapes it on node loss or gain
(`train/elastic.py`). The MPMD pipeline is not ported yet (ROADMAP
queue 1, item 9).

Reference mapping:
- TorchTrainer       <- train/data_parallel_trainer.py + backend_executor.py
- Backend/TorchConfig<- train/backend.py + train/torch/config.py
- report/get_context <- train/_internal/session.py
- Checkpoint/CheckpointManager <- train/_checkpoint.py, checkpoint_manager.py
- ScalingConfig etc <- air/config.py
"""
from ray_tpu_torch.train.backend import (Backend, BackendConfig,  # noqa: F401
                                         TorchBackend, TorchConfig)
from ray_tpu_torch.train.checkpoint import (Checkpoint,  # noqa: F401
                                            CheckpointManager, load_pytree,
                                            save_pytree)
from ray_tpu_torch.train.config import (CheckpointConfig,  # noqa: F401
                                        ElasticConfig, FailureConfig,
                                        PipelineConfig, Result, RunConfig,
                                        ScalingConfig)
from ray_tpu_torch.train.session import (get_checkpoint,  # noqa: F401
                                         get_context, get_dataset_shard,
                                         make_temp_checkpoint_dir, report,
                                         should_checkpoint)
from ray_tpu_torch.train.trainer import TorchTrainer  # noqa: F401
from ray_tpu_torch.train.worker_group import (RayTrainWorker,  # noqa: F401
                                              WorkerGroup)
