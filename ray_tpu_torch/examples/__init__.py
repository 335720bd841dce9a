"""Runnable examples of the port, the twins of the repo root's
`examples/`. Each runs as ``python -m ray_tpu_torch.examples.<name>``;
an example that puts work on a device takes ``--device`` (default: the
card; ``--device cpu`` runs it on the CPU).

| Example | Shows |
|---|---|
| `core_tasks_actors` | tasks, actors, objects, placement groups |
| `data_pipeline` | jsonl read -> map_batches -> torch batches on a device |
| `train_sft` | TorchTrainer SFT of the tiny transformer + checkpoints |
| `tune_sweep` | ASHA lr sweep over trial actors |
| `tune_pbt` | PBT exploit/inherit + distributed 2-worker trials |
| `ppo_cartpole` | PPO to 450 on CartPole |
| `multi_agent_ppo` | two policies, dict-keyed MultiAgentEnv |
| `serve_inference` | deployments + HTTP ingress |
| `serve_streaming` | token streaming (handle + chunked HTTP) + autoscaling |
| `serve_composition` | an ingress fanning out to sub-deployments |
| `serve_multi_app` | multi-application serving with route prefixes |
| `data_relational` | groupby/aggregate, sort, actor-pool map_batches |
| `data_streaming_stages` | per-operator staged execution + stats |
| `dag_collective` | allreduce collective nodes inside a compiled DAG |
"""
