"""Store, project manager, report and viz tests."""

import os

import numpy as np
import pytest

from lidar_crowd.utils.project import (
    ProjectManager)
from lidar_crowd.utils.report import (
    generate_report, risk_level)
from lidar_crowd.utils.store import ResultsStore


class TestPlaceholderTranslation:
    """sqlite '?' -> psycopg2 '%s' (PostgresStore._exec dialect hook)."""

    def test_basic(self):
        from lidar_crowd.utils.store import (
            translate_placeholders as t)
        assert t("SELECT 1 WHERE a=? AND b=?") == \
            "SELECT 1 WHERE a=%s AND b=%s"

    def test_literals_untouched(self):
        from lidar_crowd.utils.store import (
            translate_placeholders as t)
        # '?' inside a string literal must survive (the old naive
        # str.replace corrupted it)
        assert t("INSERT INTO x (q) VALUES ('what?')") == \
            "INSERT INTO x (q) VALUES ('what?')"
        # escaped quote inside the literal
        assert t("SELECT '?''?' , ?") == "SELECT '?''?' , %s"
        # percent outside literals is doubled for psycopg2
        assert t("SELECT ? WHERE a LIKE 'x%' OR b LIKE c || '%'") == \
            "SELECT %s WHERE a LIKE 'x%' OR b LIKE c || '%'"
        assert t("SELECT 100 % 7, ?") == "SELECT 100 %% 7, %s"


class TestPostgresStore:
    """Live-server integration — runs wherever LIDAR_PG_DSN or
    DATABASE_URL points at a reachable PostgreSQL (skipped otherwise;
    the shared query logic is fully covered by the SQLite suite since
    PostgresStore only overrides _exec/_insert)."""

    def test_roundtrip(self):
        import os

        import pytest
        dsn = os.environ.get("LIDAR_PG_DSN",
                             os.environ.get("DATABASE_URL", ""))
        if not dsn.startswith(("postgres://", "postgresql://")):
            pytest.skip("no PostgreSQL DSN configured")
        psycopg2 = pytest.importorskip("psycopg2")
        from lidar_crowd.utils.store import (
            PostgresStore)
        try:
            s = PostgresStore(dsn)
        except psycopg2.OperationalError:
            pytest.skip("PostgreSQL server unreachable")
        eid = s.create_event("it's a test?")  # literal stress
        aid = s.create_analysis(event_id=eid, point_summary={"n": 3})
        s.save_density_results(aid, {"total_people": 3})
        s.save_flow_results(aid, {"avg_speed": 1.0})
        rid = s.save_report(aid, "<html>100% done?</html>")
        assert s.get_report(rid)["html"] == "<html>100% done?</html>"
        assert s.get_density_results(aid)["total_people"] == 3
        rows = s.analyses_for_event(eid)
        assert rows and rows[-1]["has_density"]
        s.close()


class TestStore:
    def test_project_dataset_roundtrip(self, tmp_path):
        s = ResultsStore(str(tmp_path / "db.sqlite"))
        pid = s.create_project("p", "d")
        did = s.insert_dataset(pid, "cloud", np.random.rand(50, 3),
                               {"src": "test"})
        ds = s.get_dataset(did)
        assert ds["point_count"] == 50
        assert ds["points"].shape == (50, 3)
        assert ds["metadata"]["src"] == "test"
        assert s.list_datasets(pid)[0]["name"] == "cloud"
        s.close()

    def test_cascade_delete(self):
        s = ResultsStore()
        pid = s.create_project("p")
        s.insert_dataset(pid, "c", np.zeros((3, 3)))
        s.delete_project(pid)
        assert s.list_datasets(pid) == []

    def test_analysis_results_flow(self):
        s = ResultsStore()
        eid = s.create_event("concert", venue="arena")
        aid = s.create_analysis(event_id=eid, point_summary={"n": 10})
        s.save_density_results(aid, {"total_people": 3,
                                     "grid": np.eye(2)})
        s.save_flow_results(aid, {"avg_speed": 1.2})
        s.save_recommendations(aid, {"issues": []})
        s.save_report(aid, "<html></html>", title="t")
        assert s.get_density_results(aid)["total_people"] == 3
        assert s.get_flow_results(aid)["avg_speed"] == 1.2
        view = s.analyses_for_event(eid)
        assert view[0]["has_density"] and view[0]["has_flow"]
        assert s.list_reports()[0]["title"] == "t"

    def test_latest_result_wins(self):
        s = ResultsStore()
        aid = s.create_analysis()
        s.save_density_results(aid, {"v": 1})
        s.save_density_results(aid, {"v": 2})
        assert s.get_density_results(aid)["v"] == 2


class TestProjectManager:
    def test_project_file_roundtrip(self, tmp_path):
        pm = ProjectManager()
        pm.new_project("venue A", "test project")
        pts = np.random.RandomState(0).rand(100, 3)
        pm.add_dataset("scan1", pts, {"sensor": "VLP-16"})
        path = str(tmp_path / "proj")
        pm.save_project(path)
        assert os.path.exists(path + ".lcaz")

        pm2 = ProjectManager()
        proj = pm2.open_project(path + ".lcaz")
        assert proj.name == "venue A"
        assert len(pm2.datasets) == 1
        np.testing.assert_allclose(pm2.datasets[0].points, pts, atol=1e-6)
        assert pm2.datasets[0].metadata["sensor"] == "VLP-16"

    def test_rejects_non_project_zip(self, tmp_path):
        import zipfile
        p = str(tmp_path / "fake.lcaz")
        with zipfile.ZipFile(p, "w") as z:
            z.writestr("manifest.json", '{"format": "other"}')
        with pytest.raises(ValueError):
            ProjectManager().open_project(p)

    def test_run_analysis_and_export(self, tmp_path, fixture_points):
        pm = ProjectManager(db_path=str(tmp_path / "p.sqlite"))
        pm.new_project("venue")
        pm.add_dataset("fixture", fixture_points)
        out = pm.run_analysis()
        assert out["density"]["total_people"] == 446
        pm.export_results_json(str(tmp_path / "r.json"), "fixture")
        pm.export_results_csv(str(tmp_path / "r.csv"), "fixture")
        csv = open(tmp_path / "r.csv").read()
        assert "total_people,446" in csv
        assert "hotspot_1" in csv


class TestReport:
    def test_risk_bands(self):
        assert risk_level(0.5) == "Low"
        assert risk_level(1.5) == "Moderate"
        assert risk_level(3.0) == "High"
        assert risk_level(5.0) == "Critical"

    def test_report_html(self, fixture_points):
        from lidar_crowd.pipeline import Pipeline
        out = Pipeline().analyze(fixture_points)
        html = generate_report(out["density"], out["flow"],
                               out["recommendations"],
                               processed_summary={"points": 10000})
        assert html.startswith("<!DOCTYPE html>")
        assert "Executive Summary" in html
        assert "446" in html
        assert "data:image/png;base64," in html  # embedded figures
        assert "Critical crowd density" in html
        for step in out["recommendations"]["actions"][0]["steps"]:
            assert step[:20] in html

    def test_pdf_report_is_real_pdf(self, tmp_path, fixture_points):
        """The PDF export writes an actual PDF (magic %PDF-, multiple
        pages), not the reference's text-file-with-.pdf-extension
        (project_manager.py:379-435)."""
        from lidar_crowd.pipeline import Pipeline
        from lidar_crowd.utils.project import (
            ProjectManager)

        pm = ProjectManager()
        pm.new_project("venue")
        pm.add_dataset("fixture", fixture_points)
        pm.run_analysis()
        path = tmp_path / "out.pdf"
        pm.export_report_pdf(str(path))
        data = path.read_bytes()
        assert data[:5] == b"%PDF-"
        assert data.count(b"/Type /Page") >= 3  # summary + >=2 figures

    def test_report_without_figures(self):
        html = generate_report(
            {"total_people": 0, "avg_density": 0.0, "max_density": 0.0,
             "hotspots": []},
            {"avg_speed": 0.0, "dominant_direction": "N/A",
             "bottlenecks": [],
             "flow_vectors": {"positions": np.zeros((0, 2)),
                              "vectors": np.zeros((0, 2)),
                              "magnitudes": np.zeros(0)}},
            {"issues": [], "actions": [], "opportunities": []},
            include_figures=False)
        assert "No density hotspots" in html
        assert "No significant bottlenecks" in html


class TestViz:
    def test_figures_render(self, fixture_points):
        from lidar_crowd.pipeline import Pipeline
        from lidar_crowd.utils import viz
        out = Pipeline().analyze(fixture_points)
        for fig in [
            viz.point_cloud_figure(fixture_points,
                                   engine="matplotlib"),
            viz.density_heatmap_figure(out["density"],
                                       engine="matplotlib"),
            viz.flow_figure(out["flow"], engine="matplotlib"),
            viz.congestion_figure(out["density"], out["flow"],
                                  engine="matplotlib"),
        ]:
            b64 = viz.fig_to_base64(fig)
            assert len(b64) > 1000

    def test_color_modes_and_projection_branches(self, fixture_points):
        """Reference branches: all 4 point-cloud color modes
        (visualization.py:38-70), projection-dims histogram at
        resolution 100 and the KD-density scatter fallback (:117-191)."""
        from lidar_crowd.utils import viz
        pts = fixture_points[:3000]
        for mode in ("Height", "Density", "Distance", "Cluster"):
            clusters = (np.arange(len(pts)) % 7 if mode == "Cluster"
                        else None)
            fig = viz.point_cloud_figure(pts, clusters=clusters,
                                         color_by=mode,
                                         engine="matplotlib")
            assert len(viz.fig_to_base64(fig)) > 1000
        for dims in (("x", "y"), ("x", "z"), ("y", "z")):
            fig = viz.density_heatmap_figure(
                points=pts, projection_dims=dims, resolution=100,
                engine="matplotlib")
            assert len(viz.fig_to_base64(fig)) > 1000
        fig = viz.density_heatmap_figure(
            points=pts, as_heatmap=False, engine="matplotlib")
        assert len(viz.fig_to_base64(fig)) > 1000

    def test_plotly_builders(self, fixture_points):
        """Interactive plotly builders (visualization.py parity) — run
        wherever plotly is installed, skipped otherwise (gated import,
        like streamlit)."""
        import pytest
        pytest.importorskip("plotly")
        from lidar_crowd.pipeline import Pipeline
        from lidar_crowd.utils import viz
        out = Pipeline().analyze(fixture_points)
        figs = [
            viz.point_cloud_figure(fixture_points, engine="plotly"),
            viz.density_heatmap_figure(out["density"], engine="plotly"),
            viz.density_heatmap_figure(points=fixture_points,
                                       projection_dims=("x", "z"),
                                       engine="plotly"),
            viz.density_heatmap_figure(points=fixture_points,
                                       as_heatmap=False,
                                       engine="plotly"),
            viz.flow_figure(out["flow"], engine="plotly"),
            viz.congestion_figure(out["density"], out["flow"],
                                  engine="plotly"),
        ]
        for fig in figs:
            assert viz.is_plotly_figure(fig)
            assert fig.to_dict()["data"]  # non-empty traces

    def test_engine_auto_without_plotly(self, fixture_points):
        """auto == matplotlib when plotly is absent; explicit plotly
        raises."""
        from lidar_crowd.utils import viz
        if viz.plotly_go() is not None:
            import pytest
            pytest.skip("plotly installed: auto resolves to plotly")
        fig = viz.point_cloud_figure(fixture_points[:1000])
        assert not viz.is_plotly_figure(fig)
        import pytest
        with pytest.raises(ImportError):
            viz.point_cloud_figure(fixture_points[:1000],
                                   engine="plotly")


class TestCLI:
    def test_sample_info_analyze(self, tmp_path, capsys):
        from lidar_crowd.cli import main
        venue = str(tmp_path / "v.npy")
        assert main(["sample", "--out", venue]) == 0
        assert main(["info", venue]) == 0
        report = str(tmp_path / "r.html")
        jout = str(tmp_path / "r.json")
        db = str(tmp_path / "cli.sqlite")
        assert main(["analyze", venue, "--report", report, "--json", jout,
                     "--store", db, "--no-figures"]) == 0
        captured = capsys.readouterr().out
        assert "people detected : 446" in captured
        assert os.path.exists(report) and os.path.exists(jout)
        s = ResultsStore(db)
        assert len(s.list_reports()) == 1

    def test_analyze_downsample_options(self, tmp_path, capsys):
        """--downsample (reference random semantics) and --voxel (device
        voxel grid) both pre-thin the cloud before analysis."""
        from lidar_crowd.cli import main
        from lidar_crowd.synthetic import (
            sample_venue)
        venue = str(tmp_path / "v.npy")
        np.save(venue, sample_venue())

        assert main(["analyze", venue, "--downsample", "0.5"]) == 0
        out = capsys.readouterr().out
        assert "downsampled to 5,000 points" in out

        assert main(["analyze", venue, "--voxel", "0.4"]) == 0
        out = capsys.readouterr().out
        assert "voxel-downsampled to" in out
        n = int(out.split("voxel-downsampled to ")[1].split(" ")[0]
                .replace(",", ""))
        assert 0 < n < 10_000
