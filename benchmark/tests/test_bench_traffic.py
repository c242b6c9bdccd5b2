"""The traffic mixes against the port's own schedules, and the seeds."""

import json

import pytest
import torch

from benchmark import harness
from benchmark.drivers import finetune, pretrain, serve
from benchmark.lib import seeds, work
from benchmark.reference import mae as ref_mae
from benchmark.reference import vit as ref_vit

MAN = harness.manifest()
BIG_SEED = 2**31 + 12345


def _cell(name):
    return harness.cell(MAN, name)[1:]


def test_finetune_period_keeps_the_schedules_phase_shares():
    from tpat_tpu_torch.engine import schedules

    config, traffic = _cell("vitb16-esc50.finetune-b128")
    t = config["train"]
    phases = [schedules.schedule_phase(
        e, shrink_start_epoch=t["shrink_start_epoch"],
        shrink_epochs=t["shrink_epochs"], base_keep_rate=t["base_keep_rate"])
        for e in range(t["epochs"])]
    kinds = {"dense": "dense", "hybrid": "anneal", "static": "static"}
    period = [kinds[e["kind"]] for e in traffic["period"]]
    for phase in ("dense", "anneal", "static"):
        assert (phases.count(phase) / len(phases)
                == pytest.approx(period.count(phase) / len(period)))


def test_hybrid_rates_take_each_bucket_in_turn():
    from tpat_tpu_torch.engine import schedules

    config, traffic = _cell("vitb16-esc50.finetune-b128")
    t, m = config["train"], config["model"]
    buckets = []
    for i in range(2 * len(traffic["period"])):
        d = finetune.schedule(config, traffic, i)
        if d["kind"] != "hybrid":
            continue
        rates = tuple(d["rate"] if k in m["drop_loc"] else 1.0
                      for k in range(m["depth"]))
        snapped = schedules.bucket_keep_rates(
            rates, base_keep_rate=t["base_keep_rate"],
            n_buckets=t["anneal_buckets"])
        assert snapped[m["drop_loc"][0]] == pytest.approx(
            work.bucket_rate(d["rate"], t["base_keep_rate"],
                             t["anneal_buckets"]))
        buckets.append(round(snapped[m["drop_loc"][0]], 6))
    assert sorted(buckets) == [0.7, 0.8, 0.9, 1.0]
    # each rate lies inside the anneal's cosine (between keep 0.7 and 1)
    assert all(0.7 <= r < 1.0 for r in traffic["hybrid_rates"])


def test_the_checked_steps_take_every_step_kind():
    """The reference follows the first ``check_steps`` steps: a static
    pruned step, the dense masked one and a hybrid one, whose bucket also
    prunes."""
    config, traffic = _cell("vitb16-esc50.finetune-b128")
    steps = [finetune.schedule(config, traffic, i)
             for i in range(traffic["check_steps"])]
    assert {d["kind"] for d in steps} == {"static", "dense", "hybrid"}
    t = config["train"]
    assert all(work.bucket_rate(d["rate"], t["base_keep_rate"],
                                t["anneal_buckets"]) < 1.0
               for d in steps if d["kind"] == "hybrid")


def test_ceil_chain_is_the_programs():
    from tpat_tpu_torch.config import compose_kept_counts

    for rates in ([1, 1, 1, .7, 1, 1, .7, 1, 1, .7, 1, 1],
                  [1, 1, 1, .95, 1, 1, .95, 1, 1, .95, 1, 1]):
        assert work.ceil_chain(rates, 256) == compose_kept_counts(
            tuple(rates), 256)


@pytest.mark.parametrize("module,cell", [
    (finetune, "vitb16-esc50.finetune-b128"),
    (pretrain, "mae-dec512d8b-as.pretrain-b256"),
])
def test_a_seed_gives_the_same_inputs_twice(module, cell):
    config, traffic = _cell(cell)
    config = json.loads(json.dumps(config))
    config["model"].update(target_length=32, num_mel_bins=16)
    traffic = dict(traffic, batch=2, distinct_batches=2)
    a = module.data(config, traffic, BIG_SEED, "cpu")
    b = module.data(config, traffic, BIG_SEED, "cpu")
    c = module.data(config, traffic, BIG_SEED + 1, "cpu")
    flat = lambda d: torch.cat([t.flatten() for x in d
                                for t in (x if isinstance(x, tuple) else (x,))])
    assert torch.equal(flat(a), flat(b))
    assert not torch.equal(flat(a), flat(c))


def test_serve_clips_and_requests():
    config, traffic = _cell("vitb16-esc50.serve-b128")
    reqs = serve.requests(traffic)
    assert reqs == [(0, 128), (128, 128), (256, 128), (384, 16)]
    config = json.loads(json.dumps(config))
    config["model"].update(target_length=32, num_mel_bins=16)
    t = dict(traffic, clips=3)
    assert torch.equal(serve.clips(config, t, BIG_SEED, "cpu"),
                       serve.clips(config, t, BIG_SEED, "cpu"))


@pytest.mark.parametrize("specs", [
    ref_vit.param_specs(dict(embed_dim=32, depth=2, num_heads=2,
                             target_length=32, num_mel_bins=32,
                             num_classes=5)),
    ref_mae.param_specs(dict(embed_dim=32, depth=1, num_heads=2,
                             decoder_embed_dim=32, decoder_depth=2,
                             decoder_num_heads=2, target_length=64,
                             num_mel_bins=64)),
])
def test_weights_follow_the_seed(specs):
    a = seeds.weights(specs, BIG_SEED, "cpu")
    b = seeds.weights(specs, BIG_SEED, "cpu")
    c = seeds.weights(specs, 7, "cpu")
    assert list(a) == [n for n, _, _ in specs]
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["patch_embed.proj.weight"],
                           c["patch_embed.proj.weight"])
    assert torch.equal(a["pos_embed"], c["pos_embed"])  # the fixed table


def test_derived_seeds_differ_by_purpose_and_fit_a_generator():
    s = [seeds.derive(BIG_SEED, p) for p in ("weights", "data", "steps")]
    assert len(set(s)) == 3 and all(0 <= x < 2**63 for x in s)
    torch.Generator().manual_seed(s[0])
    assert pretrain.step_seed(BIG_SEED) * 1_000_003 + 10**6 < 2**64
