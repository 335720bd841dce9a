"""Plain-counter telemetry for the Sebulba RL subsystem (r20).

Port of `ray_tpu/rllib/sebulba/stats.py`, copied whole.

The WIRE_STATS/CH_STATS idiom: every hot path bumps module-level ints
with no locks and no metric objects; the r11 metrics plane mirrors the
dict into `ray_tpu_rl` gauges at SCRAPE time (sys.modules-guarded, so
processes that never import sebulba register nothing). Each process
reports its own slice — inference actors bump infer_*, env-runner
actors bump env_steps/shards_written/failovers, the learner process
bumps the learner_* and staleness rows — and the cluster scrape merge
labels them per node/worker.
"""

RL_STATS = {
    "env_steps": 0,          # vectorized env transitions taken
    "shards_written": 0,     # trajectory shards published into rings
    "shards_consumed": 0,    # shards the learner pulled off rings
    "steps_consumed": 0,     # unmasked env steps trained on
    "learner_updates": 0,
    "learner_version": 0,    # current policy version at the learner
    "weight_publishes": 0,   # put+broadcast+set_weights rounds
    "staleness_last": 0,     # learner_version - shard behavior version
    "staleness_max": 0,
    "failovers": 0,          # env-runner act() retargets to a survivor
    "infer_requests": 0,     # act() calls parked at inference actors
    "infer_forwards": 0,     # batched forward passes actually run
    "infer_batched_obs": 0,  # total rows pushed through those passes
    "infer_max_batch": 0,    # widest admission batch seen
}


def reset() -> None:
    """Zero every counter (test isolation)."""
    for k in RL_STATS:
        RL_STATS[k] = 0
