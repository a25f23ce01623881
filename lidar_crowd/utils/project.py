"""Project management.

Analogue of windows_implementation/core/project_manager.py: Project /
Dataset records, project files on disk, DB-backed persistence, analysis
orchestration and exporters — with two deliberate upgrades over the
reference:

  - project files are a **zip of npz + json** (``.lcaz``) instead of a
    pickle (the reference's ``.lcap`` pickles arbitrary objects,
    project_manager.py:103-168 — an unsafe format by construction);
  - ``run_analysis`` executes the real device pipeline instead of returning
    hard-coded simulated results (project_manager.py:288-361 is an
    explicit placeholder).
"""

from __future__ import annotations

import dataclasses
import datetime
import io
import json
import os
import zipfile
from typing import Dict, List, Optional

import numpy as np

from lidar_crowd.utils.store import ResultsStore


def _now() -> str:
    return datetime.datetime.now().isoformat(timespec="seconds")


@dataclasses.dataclass
class Dataset:
    """A named point cloud (core/data_loader.py:15-27)."""

    name: str
    points: np.ndarray
    metadata: Dict = dataclasses.field(default_factory=dict)

    def to_manifest(self) -> Dict:
        return {"name": self.name, "point_count": int(len(self.points)),
                "metadata": self.metadata}


@dataclasses.dataclass
class Project:
    """Project record (project_manager.py:16-60)."""

    name: str
    description: str = ""
    created_at: str = dataclasses.field(default_factory=_now)
    modified_at: str = dataclasses.field(default_factory=_now)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "Project":
        return cls(**{k: d[k] for k in
                      ("name", "description", "created_at", "modified_at")
                      if k in d})


PROJECT_EXTENSION = ".lcaz"


class ProjectManager:
    """Create/open/save projects, attach datasets, run analyses, export.

    ``db_path`` enables SQLite persistence alongside file-based projects
    (project_manager.py:170-200 DB-load analogue)."""

    def __init__(self, db_path: Optional[str] = None):
        self.current_project: Optional[Project] = None
        self.datasets: List[Dataset] = []
        self.analyses: Dict[str, Dict] = {}
        self.unsaved_changes = False
        self.store = ResultsStore(db_path) if db_path else None
        self._project_db_id: Optional[int] = None

    # -- lifecycle --

    def new_project(self, name: str, description: str = "") -> Project:
        self.current_project = Project(name=name, description=description)
        self.datasets = []
        self.analyses = {}
        self.unsaved_changes = True
        if self.store:
            self._project_db_id = self.store.create_project(name,
                                                            description)
        return self.current_project

    def add_dataset(self, name: str, points: np.ndarray,
                    metadata: Optional[Dict] = None) -> Dataset:
        if self.current_project is None:
            raise RuntimeError("no project open")
        ds = Dataset(name=name, points=np.asarray(points, np.float64),
                     metadata=metadata or {})
        self.datasets.append(ds)
        self.unsaved_changes = True
        self.current_project.modified_at = _now()
        if self.store and self._project_db_id is not None:
            self.store.insert_dataset(self._project_db_id, name,
                                      ds.points, ds.metadata)
        return ds

    # -- project files (zip of json manifest + npz arrays) --

    def save_project(self, path: str) -> None:
        if self.current_project is None:
            raise RuntimeError("no project open")
        if not path.endswith(PROJECT_EXTENSION):
            path += PROJECT_EXTENSION
        manifest = {
            "format": "lidar-crowd-project/1",
            "project": self.current_project.to_dict(),
            "datasets": [d.to_manifest() for d in self.datasets],
            "analyses": self.analyses,
        }
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("manifest.json",
                       json.dumps(manifest, default=_json_default))
            for i, ds in enumerate(self.datasets):
                buf = io.BytesIO()
                np.savez_compressed(buf, points=ds.points.astype(
                    np.float32))
                z.writestr(f"dataset_{i}.npz", buf.getvalue())
        self.unsaved_changes = False

    def open_project(self, path: str) -> Project:
        with zipfile.ZipFile(path) as z:
            manifest = json.loads(z.read("manifest.json"))
            if manifest.get("format") != "lidar-crowd-project/1":
                raise ValueError("not a lidar-crowd project file")
            self.current_project = Project.from_dict(manifest["project"])
            self.analyses = manifest.get("analyses", {})
            self.datasets = []
            for i, meta in enumerate(manifest["datasets"]):
                with z.open(f"dataset_{i}.npz") as f:
                    pts = np.load(io.BytesIO(f.read()))["points"]
                self.datasets.append(Dataset(
                    name=meta["name"], points=np.asarray(pts, np.float64),
                    metadata=meta.get("metadata", {})))
        self.unsaved_changes = False
        return self.current_project

    # -- analysis --

    def run_analysis(self, dataset_index: int = 0,
                     config=None) -> Dict:
        """Run the REAL analytics pipeline on a dataset (replaces the
        reference's simulated results, project_manager.py:288-361)."""
        from lidar_crowd.config import (
            MONOLITH_CONFIG)
        from lidar_crowd.pipeline import Pipeline

        if not self.datasets:
            raise RuntimeError("no datasets in project")
        ds = self.datasets[dataset_index]
        pipe = Pipeline(config or MONOLITH_CONFIG)
        out = pipe.analyze(ds.points)
        results = {
            "dataset": ds.name,
            "timestamp": _now(),
            "density": _jsonable(out["density"]),
            "flow": _jsonable({k: v for k, v in out["flow"].items()
                               if k != "flow_vectors"}),
            "recommendations": out["recommendations"],
        }
        self.analyses[ds.name] = results
        self.unsaved_changes = True
        if self.store and self._project_db_id is not None:
            aid = self.store.create_analysis(
                name=ds.name, point_summary={"n": len(ds.points)})
            self.store.save_density_results(aid, results["density"])
            self.store.save_flow_results(aid, results["flow"])
            self.store.save_recommendations(aid,
                                            results["recommendations"])
        # keep the full (non-jsonable) output for report generation
        self._last_full_output = out
        return out

    def generate_report(self, dataset_index: int = 0,
                        title: Optional[str] = None) -> str:
        from lidar_crowd.utils.report import (
            generate_report)
        out = getattr(self, "_last_full_output", None)
        if out is None:
            out = self.run_analysis(dataset_index)
        ds = self.datasets[dataset_index]
        return generate_report(
            out["density"], out["flow"], out["recommendations"],
            processed_summary={"dataset": ds.name,
                               "points": len(ds.points)},
            title=title or f"Crowd Analysis — {ds.name}")

    def export_report_pdf(self, path: str, dataset_index: int = 0,
                          title: Optional[str] = None) -> None:
        """Real multi-page PDF (the reference's generate_pdf_report,
        project_manager.py:379-435, writes plain text with a .pdf
        extension; this writes an actual PDF via matplotlib)."""
        from lidar_crowd.utils.report import (
            generate_pdf_report)
        out = getattr(self, "_last_full_output", None)
        if out is None:
            out = self.run_analysis(dataset_index)
        ds = self.datasets[dataset_index]
        generate_pdf_report(
            path, out["density"], out["flow"], out["recommendations"],
            processed_summary={"dataset": ds.name,
                               "points": len(ds.points)},
            title=title or f"Crowd Analysis — {ds.name}")

    # -- exporters (project_manager.py:547-606) --

    def export_results_json(self, path: str, dataset_name: str) -> None:
        with open(path, "w") as f:
            json.dump(self.analyses[dataset_name], f, indent=2,
                      default=_json_default)

    def export_results_csv(self, path: str, dataset_name: str) -> None:
        res = self.analyses[dataset_name]
        rows = [("metric", "value")]
        d = res["density"]
        f_ = res["flow"]
        rows += [("total_people", d["total_people"]),
                 ("avg_density", d["avg_density"]),
                 ("max_density", d["max_density"]),
                 ("avg_speed", f_["avg_speed"]),
                 ("dominant_direction", f_["dominant_direction"])]
        for i, h in enumerate(d.get("hotspots", []), 1):
            rows.append((f"hotspot_{i}",
                         f"({h['x']:.2f};{h['y']:.2f};{h['density']:.3f})"))
        for i, b in enumerate(f_.get("bottlenecks", []), 1):
            rows.append((f"bottleneck_{i}",
                         f"({b['x']:.2f};{b['y']:.2f};{b['severity']})"))
        with open(path, "w") as fh:
            for k, v in rows:
                fh.write(f"{k},{v}\n")


def _json_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    raise TypeError(f"not jsonable: {type(o)}")


def _jsonable(d: Dict) -> Dict:
    return json.loads(json.dumps(d, default=_json_default))
