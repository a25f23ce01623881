"""Product tests for the neural serving path (VERDICT r2 item 1).

The shipped checkpoint (assets/crowdnet_tiny.npz) must (a) load through
``NeuralPipeline`` and emit the reference-shaped analysis contract, and
(b) beat the no-skill density floor on held-out venues by the release
gate's margin.

The reference only documents this ambition (windows_design.md:60-66);
these tests pin the delivered capability.
"""

import numpy as np
import pytest

from lidar_crowd import neural
from lidar_crowd.models import train as T
from lidar_crowd.synthetic import sample_venue


@pytest.fixture(scope="module")
def pipe():
    return neural.NeuralPipeline()


def test_checkpoint_ships_and_loads(pipe):
    params, cfg = T.load_params_npz(neural.default_checkpoint_path())
    assert cfg.n_points == pipe.train_config.n_points
    n_params = sum(int(np.prod(v.shape))
                   for v in __import__("jax").tree_util.tree_leaves(params))
    assert n_params > 10_000  # a real model, not a stub
    # APPLY the params to the current module definition: round 3 shipped
    # an artifact missing the new count_head params and this test's
    # key-count check let it through — a structure-drifted checkpoint
    # must fail here, not at first serve
    pts = sample_venue(n_points=cfg.n_points, n_people=20, seed=1)
    vmin = pts[:, :2].min(axis=0).astype(np.float32)
    vsize = float(np.ptp(pts[:, :2], axis=0).max()) + 1e-6
    out = pipe.forward(pts, vmin, vsize)
    assert set(out) == {"density", "flow", "congestion", "count"}
    assert np.isfinite(out["count"])


def test_heldout_density_beats_zero_floor(pipe):
    """The release gate, re-checked against the committed artifact:
    held-out density MAE < 0.5x the zero-predictor floor on realistic
    blob venues. The speckle regime (people = 1-4 elevated returns, at
    the information floor by construction) is excluded here — it is
    gated by the golden-fixture count band below — but the mixed stream
    must still show clear skill over the floor."""
    import dataclasses as dc
    blob_cfg = dc.replace(pipe.train_config, speckle_prob=0.0)
    ev = T.evaluate(pipe.params, blob_cfg, n_venues=4, seed=77_000)
    assert ev["density_mae"] < 0.5 * ev["density_mae_zero"], ev
    assert ev["people_rel_err"] < 0.5, ev
    mix = T.evaluate(pipe.params, pipe.train_config, n_venues=4,
                     seed=78_000)
    assert mix["density_mae"] < 0.85 * mix["density_mae_zero"], mix


def test_analyze_contract_and_sanity(pipe):
    """End-to-end on the golden fixture: reference-shaped dicts, a
    people count in the right decade, hotspots in-bounds."""
    pts = sample_venue(n_points=4096, n_people=50, seed=42)
    out = pipe.analyze(pts)

    d = out["density"]
    g = pipe.train_config.grid
    assert d["density_map"].shape == (g, g)
    assert d["density_grid"].shape == (g, g)
    # 50 true people; the count head must land in a sane band
    assert 10 <= d["total_people"] <= 150
    for h in d["hotspots"]:
        assert -16 <= h["x"] <= 16 and -16 <= h["y"] <= 16

    f = out["flow"]
    assert f["flow_vectors"]["vectors"].shape == (g * g, 2)
    assert f["avg_speed"] >= 0.0
    assert f["dominant_direction"] in {"E", "NE", "N", "NW", "W", "SW",
                                       "S", "SE"}
    for b in f["bottlenecks"]:
        assert 0 <= b["severity"] <= 10

    assert out["congestion"]["map"].shape == (g, g)
    assert 0.0 <= float(out["congestion"]["map"].min())
    assert float(out["congestion"]["map"].max()) <= 1.0
    # the shared reference shape (utils/recommendations.py:59): the dict
    # the analytic Pipeline.analyze emits, so reports/stores are shared
    rec = out["recommendations"]
    assert set(rec) == {"issues", "actions", "opportunities"}
    assert rec["opportunities"], "non-trivial scene must recommend"


def test_checkpoint_with_removed_option_loads(tmp_path, pipe):
    """Artifacts written while TrainConfig still had ``use_pallas`` (the
    packaged one among them) load: the removed key is dropped, the rest
    of the config and every parameter are kept."""
    import json

    src = neural.default_checkpoint_path()
    with np.load(src, allow_pickle=False) as z:
        kept = {k: z[k] for k in z.files}
    cfg = json.loads(str(kept["config_json"]))
    cfg["use_pallas"] = True
    kept["config_json"] = np.asarray(json.dumps(cfg))
    old = tmp_path / "old_option.npz"
    np.savez_compressed(old, **kept)

    params, tcfg = T.load_params_npz(str(old))
    assert not hasattr(tcfg, "use_pallas")
    assert tcfg == pipe.train_config
    pts = sample_venue(n_points=2048, n_people=30, seed=7)
    vmin = pts[:, :2].min(axis=0).astype(np.float32)
    vsize = float(np.ptp(pts[:, :2], axis=0).max()) + 1e-6
    a = pipe.forward(pts, vmin, vsize)
    b = neural.NeuralPipeline(str(old)).forward(pts, vmin, vsize)
    np.testing.assert_array_equal(a["density"], b["density"])


def test_downsample_branch_over_capacity(pipe):
    """Clouds above the model's static capacity go through the
    reference downsampler semantics (uniform subset) and still emit a
    full contract."""
    pts = sample_venue(n_points=9000, n_people=40, seed=3)
    out = pipe.analyze(pts)
    assert out["density"]["total_people"] > 0


def test_neural_tracks_analytic_pipeline_on_same_clouds(pipe):
    """Cross-validation of the distillation claim (VERDICT r3 item 7):
    the SAME held-out venues through BOTH pipelines. Bounds measured
    over 5 venues and recorded in docs/PARITY.md ("Neural vs analytic"):

      - neural vs GENERATOR-TRUE count: rel err < 0.18 per venue
        (measured <= 0.17; ratcheted from 0.20 in r5) — the
        distillation estimand;
      - neural vs ANALYTIC count: rel err < 0.55 per venue (measured
        0.35-0.53; ratcheted from 0.60 in r5). The gap is the analytic path's own bias: fixed
        eps=0.3 DBSCAN over-segments ~24-return person blobs into
        ~1.6-1.7x the true cluster count on these venues, while the
        count head was supervised with the true count;
      - density MAE on the neural BEV lattice vs the analytic-people
        histogram: venue-mean < 0.8x the zero floor (measured 0.55-0.74
        per venue — the same over-segmentation doubles some spikes)."""
    import dataclasses as dc

    from lidar_crowd.pipeline import Pipeline

    analytic = Pipeline()
    blob_cfg = dc.replace(pipe.train_config, speckle_prob=0.0)
    g = pipe.train_config.grid
    maes, floors = [], []
    rng = np.random.RandomState(880_000)  # held out from train/eval
    for _ in range(2):
        ex = T.synth_example(rng, blob_cfg)
        pts = np.asarray(ex["points"], np.float64)
        cell_lbl = float(ex["venue_size"]) / g
        true_n = float(ex["density"].sum()) * cell_lbl ** 2

        a = analytic.analyze(pts)
        n = pipe.analyze(pts)

        a_count = a["density"]["total_people"]
        n_count = n["density"]["total_people"]
        assert abs(n_count - true_n) / max(true_n, 1) < 0.18, \
            (true_n, n_count)
        assert abs(n_count - a_count) / max(a_count, 1) < 0.55, \
            (a_count, n_count)

        # analytic people -> density on the neural BEV lattice
        ppl = a["people"]
        pos = np.asarray(ppl.positions)[np.asarray(ppl.mask)]
        vmin = pts[:, :2].min(axis=0)
        vsize = float(np.ptp(pts[:, :2], axis=0).max()) + 1e-6
        cell = vsize / g
        ci = np.clip(((pos - vmin) / cell).astype(int), 0, g - 1)
        hist = np.zeros((g, g), np.float32)
        np.add.at(hist, (ci[:, 0], ci[:, 1]), 1.0)
        hist /= cell ** 2

        maes.append(np.abs(n["density"]["density_map"] - hist).mean())
        floors.append(np.abs(hist).mean())
    assert np.mean(maes) < 0.8 * np.mean(floors), (maes, floors)


def test_neural_on_reference_fixtures(pipe):
    """The reference's own fixtures through the neural path (VERDICT r4
    item 5: the eval never touched seed-42 or scaled_venue).

    These venues are OFF the blob training family: seed-42 carries
    sinusoidal terrain whose DBSCAN census (446) counts terrain
    clusters, and scaled_venue(50k) is ~4x the training venue extent.
    Measured r5 (docs/PARITY.md "Reference fixtures"): neural count 26
    on seed-42 (true 50 people, analytic census 446) and 16 on
    scaled_venue(50k) (analytic census 2236).  The bands below are
    REGRESSION gates pinned around those measurements — a retrain that
    drifts off them fails here; they are not accuracy claims."""
    from lidar_crowd.pipeline import Pipeline
    from lidar_crowd.synthetic import (
        sample_venue, scaled_venue)

    pts42 = sample_venue()                      # app_simplified.py:994-1024
    n42 = pipe.analyze(pts42)
    c42 = n42["density"]["total_people"]
    # true people = 50; measured 26 -> band [0.3, 1.5] x true
    assert 15 <= c42 <= 75, c42
    assert np.isfinite(n42["density"]["max_density"])
    assert set(n42["recommendations"]) == {"issues", "actions",
                                           "opportunities"}

    pts50k = scaled_venue(50_000)
    n50k = pipe.analyze(pts50k)
    assert n50k["density"]["total_people"] >= 1
    assert np.isfinite(n50k["density"]["max_density"])


def test_legacy_checkpoint_without_count_head_serves(tmp_path, pipe):
    """Pre-count-head artifacts (e.g. from an older `lidar-crowd train`)
    must keep serving: counts fall back to the density integral instead
    of crashing at apply time (ADVICE r3)."""
    src = neural.default_checkpoint_path()
    legacy = tmp_path / "legacy.npz"
    with np.load(src, allow_pickle=False) as z:
        kept = {k: z[k] for k in z.files if "count_head" not in k}
    np.savez_compressed(legacy, **kept)

    lp = neural.NeuralPipeline(str(legacy))
    assert lp._legacy_count
    pts = sample_venue(n_points=2048, n_people=30, seed=5)
    out = lp.analyze(pts)
    assert out["density"]["total_people"] >= 0
    assert set(out["recommendations"]) == {"issues", "actions",
                                           "opportunities"}


def test_mismatched_checkpoint_raises_named_error(tmp_path):
    """A checkpoint whose tree neither matches the model nor fits the
    legacy migration must fail at load with a ValueError naming the
    format mismatch, not at apply time with an opaque flax error
    (ADVICE r4)."""
    src = neural.default_checkpoint_path()
    broken = tmp_path / "broken.npz"
    with np.load(src, allow_pickle=False) as z:
        kept = {k: z[k] for k in z.files}
    # drop one count-head param and corrupt another's shape: the
    # partial count head defeats the has-density/no-count migration gate
    drop = [k for k in kept if "count_head" in k][0]
    del kept[drop]
    wk = [k for k in kept if k.endswith("kernel") and "__cfg__" not in k][0]
    kept[wk] = kept[wk][..., :1]
    np.savez_compressed(broken, **kept)

    with pytest.raises(ValueError, match="format mismatch"):
        neural.NeuralPipeline(str(broken))


def test_cli_analyze_neural_smoke(tmp_path, capsys):
    """lidar-crowd analyze --neural uses the packaged checkpoint."""
    from lidar_crowd import cli

    pts = sample_venue(n_points=2048, n_people=30, seed=9)
    p = tmp_path / "cloud.npy"
    np.save(p, pts)
    rc = cli.main(["analyze", str(p), "--neural"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "people" in out.lower()
