"""Drive the Streamlit app's DB-backed lifecycle (VERDICT r2 item 7).

streamlit (and so ``st.testing.v1.AppTest``) is not installable in this
environment, so — like the PostgresStore fake-DBAPI contract suite — the
app is executed against a strict scripted fake of the streamlit API it
uses. Each ``rerun`` re-executes ``app.main()`` exactly like a streamlit
interaction would (widget values scripted per label, ``session_state``
persisted across runs), and the assertions check the reference lifecycle
(app_with_db.py:1058-1516): analysis auto-created on upload, density+flow
saved right after the analyze stage, recommendations saved once, report
saved and browsable by id — all verified against the real SQLite store.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import types

import numpy as np
import pytest


class _SessionState(dict):
    """Attribute + mapping hybrid, like st.session_state."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v


class _Recorder:
    """Records every display call; widget values come from the script."""

    def __init__(self, fake):
        self._fake = fake

    def __getattr__(self, name):
        def sink(*a, **kw):
            self._fake.calls.append((name, a))
        return sink


class FakeStreamlit(types.ModuleType):
    """The subset of the streamlit API app.main() touches.

    Widget reads return ``script[label]`` when scripted, else the
    widget's natural default (checkbox/button False, text_input its
    default, radio/selectbox the first option)."""

    def __init__(self):
        super().__init__("streamlit")
        self.session_state = _SessionState()
        self.script = {}
        self.calls = []
        self.sidebar = _SidebarProxy(self)
        self.components = types.SimpleNamespace(
            v1=types.SimpleNamespace(
                html=lambda *a, **k: self.calls.append(("html", a))))

    # -- widgets -------------------------------------------------------------
    def _value(self, label, default):
        return self.script.get(label, default)

    def text_input(self, label, value="", **kw):
        return self._value(label, value)

    def checkbox(self, label, value=False, **kw):
        return self._value(label, value)

    def button(self, label, **kw):
        return bool(self._value(label, False))

    def radio(self, label, options, **kw):
        return self._value(label, options[0])

    def selectbox(self, label, options, **kw):
        options = list(options)
        if not options:
            return None
        return self._value(label, options[0])

    def file_uploader(self, label, **kw):
        return self._value(label, None)

    def download_button(self, label, *a, **kw):
        self.calls.append(("download_button", (label,)))
        return False

    # -- layout --------------------------------------------------------------
    def tabs(self, labels):
        return [_Block(self) for _ in labels]

    def columns(self, n):
        return [_Block(self) for _ in range(n)]

    def expander(self, label, **kw):
        return _Block(self)

    def spinner(self, text=""):
        return contextlib.nullcontext()

    # -- display sinks ---------------------------------------------------------
    def __getattr__(self, name):
        def sink(*a, **kw):
            self.calls.append((name, a))
        return sink


class _Block(contextlib.AbstractContextManager):
    """A tab / column / expander: context manager + display sink."""

    def __init__(self, fake):
        self._fake = fake

    def __exit__(self, *exc):
        return False

    def __getattr__(self, name):
        def sink(*a, **kw):
            self._fake.calls.append((name, a))
        return sink


class _SidebarProxy:
    def __init__(self, fake):
        self._fake = fake

    def text_input(self, label, value="", **kw):
        return self._fake.text_input(label, value)

    def checkbox(self, label, value=False, **kw):
        return self._fake.checkbox(label, value)

    def __getattr__(self, name):
        def sink(*a, **kw):
            self._fake.calls.append(("sidebar." + name, a))
        return sink


@pytest.fixture()
def fake_app(monkeypatch, tmp_path):
    fake = FakeStreamlit()
    monkeypatch.setitem(sys.modules, "streamlit", fake)
    import lidar_crowd.app as app_mod
    app = importlib.reload(app_mod)
    assert app.HAVE_STREAMLIT
    fake.script["SQLite path"] = str(tmp_path / "lifecycle.sqlite")

    def rerun():
        fake.calls.clear()
        app.main()

    yield fake, rerun, str(tmp_path / "lifecycle.sqlite")
    # restore the real (gated) module state for other tests
    monkeypatch.delitem(sys.modules, "streamlit", raising=False)
    importlib.reload(app_mod)


def _texts(fake, kind):
    return [a[0] for name, a in fake.calls if name == kind and a]


def test_db_backed_lifecycle(fake_app):
    from lidar_crowd.utils.store import (
        ResultsStore)

    fake, rerun, db_path = fake_app

    # run 1 — upload the sample: analysis row auto-created
    # (app_with_db.py:1058-1121)
    fake.script["Use generated sample data"] = True
    rerun()
    ss = fake.session_state
    assert ss.points is not None and len(ss.points) == 10_000
    aid = ss.analysis_id
    assert aid is not None
    store = ResultsStore(db_path)
    events = store.list_events()
    assert len(events) == 1
    assert store.analyses_for_event(events[0]["id"])

    # run 2 — click "Run analysis": density+flow saved right after the
    # stage (:1238,1279); recommendations render + save once (:1329)
    fake.script["Run analysis"] = True
    rerun()
    fake.script["Run analysis"] = False
    assert ss.analysis_id == aid  # same session upload, same analysis
    d = store.get_density_results(aid)
    f = store.get_flow_results(aid)
    assert d and d["total_people"] == 446  # golden fixture parity
    assert f and "avg_speed" in f
    assert store.get_recommendations(aid)
    assert ss.recs_saved

    # run 3 — generate the report: saved + offered for download (:1426)
    fake.script["Generate report"] = True
    rerun()
    fake.script["Generate report"] = False
    reports = store.list_reports()
    assert len(reports) == 1
    assert any(n == "download_button" for n, _ in fake.calls)

    # run 4 — browse the report back by id (:1441-1508)
    fake.script["Open report"] = True
    rerun()
    htmls = _texts(fake, "html")
    assert htmls and "<html" in htmls[-1].lower()

    # recommendations are saved once per analysis, not once per rerun
    with store.conn:
        n_recs = store.conn.execute(
            "SELECT COUNT(*) FROM recommendations WHERE analysis_id=?",
            (aid,)).fetchone()[0]
    assert n_recs == 1
    store.close()


def test_new_upload_starts_new_analysis(fake_app):
    from lidar_crowd.utils.store import (
        ResultsStore)

    fake, rerun, db_path = fake_app
    fake.script["Use generated sample data"] = True
    rerun()
    first = fake.session_state.analysis_id
    rerun()  # plain rerun, same upload action -> SAME analysis row
    assert fake.session_state.analysis_id == first

    fake.script["Use generated sample data"] = False
    rerun()  # un-check: the next check is a new upload action
    fake.script["Use generated sample data"] = True
    rerun()
    second = fake.session_state.analysis_id
    assert second != first
    store = ResultsStore(db_path)
    assert len(store.list_events()) == 2
    store.close()


def test_autosave_off_touches_no_db(fake_app, tmp_path):
    fake, rerun, db_path = fake_app
    fake.script["Use generated sample data"] = True
    fake.script["Auto-save stages to database"] = False
    rerun()
    assert fake.session_state.analysis_id is None
    # the Database tab still opens a store; it must be empty
    from lidar_crowd.utils.store import (
        ResultsStore)
    store = ResultsStore(db_path)
    assert store.list_events() == []
    store.close()


def test_neural_variant_serves_and_autosaves(fake_app):
    """The Analyze tab's 'neural' variant serves CrowdNet end-to-end
    through the app — results render the same metric surface and the
    per-stage auto-save writes the same rows as the analytic variants."""
    from lidar_crowd.utils.store import (
        ResultsStore)

    fake, rerun, db_path = fake_app
    fake.script["Use generated sample data"] = True
    rerun()
    fake.script["Use generated sample data"] = False

    fake.script["Variant"] = "neural"
    fake.script["Run analysis"] = True
    rerun()
    fake.script["Run analysis"] = False

    s = ResultsStore(db_path)
    analyses = s.analyses_for_event(1)
    assert len(analyses) == 1 and analyses[0]["has_density"]
    aid = analyses[0]["id"]
    d = s.get_density_results(aid)
    assert d["total_people"] > 0  # the count head, through the app
    assert s.get_flow_results(aid)["dominant_direction"] in {
        "E", "NE", "N", "NW", "W", "SW", "S", "SE"}
