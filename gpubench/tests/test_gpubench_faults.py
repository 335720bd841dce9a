"""`correct` comes out false when the timed path is broken underneath,
once for each fault a cell can have, with the run driven as `run.py`
drives it (the harness's look for a card skipped): a token altered
where it is produced; a decode step that leaves its state (the K/V
cache) unchanged; a training step that leaves its state unchanged; half
of the batch left out, the mean taken over the rest. (The exchange
between cards is no fault a one-card cell can have.) Sound runs of the
same tiny cells come out correct. Then the control at test size: the
reference in fp8 in the program's place reads at least three times
what the program reads, and it, like each fault, comes out not correct
against the cell's committed limits, through the comparison `run.py`
and `control.py` make."""
import torch

from tiny import run_tiny, tiny_cell

import pytest

from gpubench import core, judge, load, weights
from gpubench.reference import decoder
from gpubench.serving import Req

SERVE = ["mistral-7b.chat"]


def f32(cell):
    cell["config"]["run"] = {**cell["config"]["run"], "dtype": "float32",
                             "param_dtype": "float32"}
    return cell


@pytest.mark.parametrize("name", SERVE + ["mixtral-8x7b.train"])
def test_sound_runs_are_correct(name):
    rec, out = run_tiny(f32(tiny_cell(name)))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", SERVE)
def test_a_token_altered_where_it_is_produced(name, monkeypatch):
    from ray_tpu_torch.serve.llm.engine import EngineCore
    real = EngineCore._decode

    def altered(self, *args):
        out = real(self, *args)
        out[0] = (out[0] + 1) % self.config.vocab_size
        return out
    monkeypatch.setattr(EngineCore, "_decode", altered)
    rec, out = run_tiny(f32(tiny_cell(name)))
    assert not out["correct"]
    assert out["checks"]["logit_gap"]["value"] > \
        out["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("name", SERVE)
def test_a_decode_step_that_leaves_the_cache_unchanged(name, monkeypatch):
    from ray_tpu_torch.models import decode
    real = decode.decode_step

    def stale(model, params, cache, *args, **kw):
        scratch = {k: v.clone() for k, v in cache.items()}
        logits, _ = real(model, params, scratch, *args, **kw)
        return logits, cache
    monkeypatch.setattr(decode, "decode_step", stale)
    rec, out = run_tiny(f32(tiny_cell(name)))
    assert not out["correct"], out["checks"]


def test_a_training_step_that_leaves_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    rec, out = run_tiny(f32(tiny_cell("mixtral-8x7b.train")))
    assert not out["correct"]
    assert out["checks"]["update_norm_gap"]["value"] == 1.0
    assert out["checks"]["grad_norm_gap"]["value"] == 1.0


def test_half_of_the_batch_left_out(monkeypatch):
    from ray_tpu_torch.models.transformer import Transformer
    real = Transformer.loss

    def half(self, params, batch):
        t = batch["tokens"]
        return real(self, params, {"tokens": t[:t.shape[0] // 2]})
    monkeypatch.setattr(Transformer, "loss", half)
    rec, out = run_tiny(f32(tiny_cell("mixtral-8x7b.train")))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_serving_control_reads_three_times_the_program(seed):
    cell = tiny_cell("mistral-7b.chat")
    rec, _ = run_tiny(cell, seed=seed)
    done = [r for r in rec["requests"] if r.done and not r.failed]
    checks, summary = judge.serving(cell, seed, done,
                                    torch.device("cpu"), 60, control=True)
    assert summary["control_logit_gap"] >= \
        3 * checks["logit_gap"]["value"]


def greedy(cell: dict, seed: int, prompt_len: int, n: int) -> Req:
    """A request served as a sound program serves it: the reference's
    own greedy tokens, from the seed's weights and prompt."""
    conf, cpu = cell["config"], torch.device("cpu")
    params = weights.make_params(core.dims(conf), seed, cpu,
                                 judge.served_dtype(conf), stacked=True)
    rcfg = decoder.sizes(conf)
    prompt = load.prompts([prompt_len], conf["vocab_size"], seed, 3)[0]
    out = []
    for _ in range(n):
        lg = decoder.logits(params, torch.tensor(prompt + out), rcfg,
                            rows=slice(-1, None))
        out.append(int(lg[0].argmax()))
    r = Req("greedy", prompt, n)
    r.toks, r.done = out, True
    return r


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_serving_control_fails_the_committed_limit(seed):
    """At the served model's depth ratio and vocabulary (16 layers,
    32,768 tokens; narrow widths), over 120 served tokens: the sound
    sample passes the cell's committed limit, the control does not."""
    cell = tiny_cell("mistral-7b.chat")
    cell["config"].update(vocab_size=32768, num_hidden_layers=16,
                          hidden_size=128, intermediate_size=256)
    r = greedy(cell, seed, 24, 120)
    checks, summary = judge.serving(cell, seed, [r], torch.device("cpu"),
                                    400, control=True)
    low = core.check(summary["control_logit_gap"],
                     cell["limits"]["logit_gap"])
    assert checks["logit_gap"]["ok"] and not low["ok"], (checks, low)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_training_control_reads_three_times_the_program(seed):
    cell = tiny_cell("mixtral-8x7b.train")
    rec, out = run_tiny(cell, seed=seed)
    prog = {k: v["value"] for k, v in out["checks"].items()}
    prog["loss_gap"] = rec["notes"]["loss_gap"]
    batches = rec["first_batches"]
    ref = judge.reference_training(cell, rec["seed"], batches, torch.device("cpu"))
    low = judge.training_numbers(judge.reference_training(
        cell, rec["seed"], batches, torch.device("cpu"), quant="fp8"), ref)
    assert any(low[k] >= 3 * prog[k] for k in low), (low, prog)
    assert out["correct"]
    checks = judge.training_checks(low, cell["limits"])
    assert not all(c["ok"] for c in checks.values()), checks
    assert decoder.E4M3_MAX == 448.0


def test_the_judge_runs_only_in_its_room(monkeypatch):
    """Memory of the engine still allocated after its close fails the
    serving check, with the bytes held named, and the judge does not
    run."""
    from gpubench import serving
    readings = iter([1024, 1024 + 4096])
    monkeypatch.setattr(serving, "allocated", lambda device: next(readings))
    monkeypatch.setattr(judge, "serving", None)
    rec, out = run_tiny(f32(tiny_cell("mistral-7b.chat")), seconds=1.0)
    assert not out["correct"]
    assert out["checks"]["logit_gap"]["value"] is None
    assert "4096 bytes" in rec["checks"]["logit_gap"]["why"]
