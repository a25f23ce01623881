"""Drive the Tkinter desktop shell with a scripted fake (VERDICT r3
item 8 — the round-3 Streamlit-fake pattern applied to ``desktop.main``).

No display exists here, so a fake ``tkinter`` (+ ``filedialog`` /
``messagebox`` / ``ttk`` and a fake ``FigureCanvasTkAgg``) is installed
in ``sys.modules`` and the menu commands the real shell registers are
invoked from inside ``mainloop``: new project -> premature analysis
(warning path) -> import -> F5 analysis -> close-guard cancel -> save ->
report -> reopen -> clean quit. Assertions check the real
``ProjectManager`` side effects (reference shell:
windows_implementation/main.py:391-415).
"""

from __future__ import annotations

import sys
import types

import pytest


class FakeWidget:
    def __init__(self, *a, **kw):
        pass

    def pack(self, *a, **kw):
        pass

    def destroy(self):
        pass


class FakeMenu:
    def __init__(self, master=None, tearoff=0):
        self.commands = {}
        self.cascades = {}

    def add_command(self, label=None, command=None, accelerator=None):
        self.commands[label] = command

    def add_separator(self):
        pass

    def add_cascade(self, label=None, menu=None):
        self.cascades[label] = menu


class FakeStringVar:
    instances = []

    def __init__(self, value=""):
        self._v = value
        FakeStringVar.instances.append(self)

    def set(self, v):
        self._v = v

    def get(self):
        return self._v


class FakeTk:
    # the test injects the scripted interaction here; it runs inside
    # mainloop exactly where a user would drive the real event loop
    script = staticmethod(lambda root: None)
    last = None

    def __init__(self):
        FakeTk.last = self
        self.menubar = None
        self.bindings = {}
        self.protocols = {}
        self.destroyed = False
        self.status_vars = []

    def title(self, t):
        self._title = t

    def geometry(self, g):
        pass

    def config(self, menu=None, **kw):
        if menu is not None:
            self.menubar = menu

    def bind(self, seq, fn):
        self.bindings[seq] = fn

    def protocol(self, name, fn):
        self.protocols[name] = fn

    def update_idletasks(self):
        pass

    def destroy(self):
        self.destroyed = True

    def mainloop(self):
        FakeTk.script(self)


class FakeCanvas:
    drawn = 0

    def __init__(self, fig, master=None):
        self.fig = fig

    def draw(self):
        FakeCanvas.drawn += 1

    def get_tk_widget(self):
        return FakeWidget()


@pytest.fixture()
def fake_tk(monkeypatch):
    tk_mod = types.ModuleType("tkinter")
    tk_mod.Tk = FakeTk
    tk_mod.Menu = FakeMenu
    tk_mod.StringVar = FakeStringVar

    fd = types.ModuleType("tkinter.filedialog")
    fd.queue = []
    fd.askopenfilename = lambda **kw: fd.queue.pop(0) if fd.queue else ""
    fd.asksaveasfilename = (
        lambda **kw: fd.queue.pop(0) if fd.queue else "")

    mb = types.ModuleType("tkinter.messagebox")
    mb.warnings = []
    mb.okcancel_script = []
    mb.showwarning = lambda *a, **kw: mb.warnings.append(a)
    mb.askokcancel = lambda *a, **kw: mb.okcancel_script.pop(0)

    ttk_mod = types.ModuleType("tkinter.ttk")
    ttk_mod.Frame = FakeWidget
    ttk_mod.Label = FakeWidget

    tk_mod.filedialog = fd
    tk_mod.messagebox = mb
    tk_mod.ttk = ttk_mod

    agg = types.ModuleType("matplotlib.backends.backend_tkagg")
    agg.FigureCanvasTkAgg = FakeCanvas

    for name, mod in (("tkinter", tk_mod),
                      ("tkinter.filedialog", fd),
                      ("tkinter.messagebox", mb),
                      ("tkinter.ttk", ttk_mod),
                      ("matplotlib.backends.backend_tkagg", agg)):
        monkeypatch.setitem(sys.modules, name, mod)
    FakeCanvas.drawn = 0
    return tk_mod


def test_desktop_shell_full_session(fake_tk, tmp_path):
    from lidar_crowd import desktop
    from lidar_crowd.synthetic import sample_venue
    from lidar_crowd.utils import io as pio

    pts = sample_venue(n_points=2000, n_people=25, seed=6)
    npy = tmp_path / "venue.npy"
    pio.save_points(str(npy), pts)
    proj = tmp_path / "session.lcaz"
    report = tmp_path / "report.html"

    fd = fake_tk.filedialog
    mb = fake_tk.messagebox
    statuses = []

    def script(root):
        menus = root.menubar.cascades
        filem, anm = menus["File"], menus["Analysis"]

        filem.commands["New Project"]()
        # premature analysis: warning, no crash
        anm.commands["Run Analysis"]()
        assert len(mb.warnings) == 1

        fd.queue.append(str(npy))
        filem.commands["Import Data..."]()
        assert FakeCanvas.drawn == 1  # imported cloud rendered

        root.bindings["<F5>"](None)  # analysis via the accelerator
        assert FakeCanvas.drawn == 2  # density heatmap rendered

        # close guard: unsaved changes + cancel keeps the window alive
        mb.okcancel_script.append(False)
        root.protocols["WM_DELETE_WINDOW"]()
        assert not root.destroyed

        fd.queue.append(str(proj))
        filem.commands["Save Project..."]()

        fd.queue.append(str(report))
        anm.commands["Generate Report..."]()

        fd.queue.append(str(proj))
        filem.commands["Open Project..."]()

        filem.commands["Quit"]()
        statuses.append(root.destroyed)

    FakeTk.script = staticmethod(script)
    desktop.main()

    root = FakeTk.last
    assert statuses == [True] and root.destroyed
    assert proj.exists(), "Save Project wrote the .lcaz archive"
    html = report.read_text()
    assert "<html" in html.lower() and "people" in html.lower()


def test_desktop_status_reflects_analysis(fake_tk, tmp_path):
    """The statusbar line after F5 carries the real analysis numbers."""
    from lidar_crowd import desktop
    from lidar_crowd.synthetic import sample_venue
    from lidar_crowd.utils import io as pio

    pts = sample_venue(n_points=2000, n_people=25, seed=6)
    npy = tmp_path / "v.npy"
    pio.save_points(str(npy), pts)
    fd = fake_tk.filedialog
    seen = {}

    def script(root):
        menus = root.menubar.cascades
        fd.queue.append(str(npy))
        menus["File"].commands["Import Data..."]()
        menus["Analysis"].commands["Run Analysis"]()
        seen["status"] = FakeStringVar.instances[-1].get()
        root.destroy()

    FakeTk.script = staticmethod(script)
    desktop.main()
    assert "people=" in seen["status"] and "m/s" in seen["status"]


def test_desktop_neural_analysis(fake_tk, tmp_path):
    """The Analysis menu's neural entry serves CrowdNet through the
    shell: real count in the statusbar, heatmap rendered."""
    from lidar_crowd import desktop
    from lidar_crowd.synthetic import sample_venue
    from lidar_crowd.utils import io as pio

    pts = sample_venue(n_points=2048, n_people=25, seed=8)
    npy = tmp_path / "v.npy"
    pio.save_points(str(npy), pts)
    fd = fake_tk.filedialog
    seen = {}

    def script(root):
        menus = root.menubar.cascades
        fd.queue.append(str(npy))
        menus["File"].commands["Import Data..."]()
        drawn_before = FakeCanvas.drawn
        menus["Analysis"].commands["Run Neural Analysis"]()
        seen["status"] = FakeStringVar.instances[-1].get()
        seen["drew"] = FakeCanvas.drawn == drawn_before + 1
        root.destroy()

    FakeTk.script = staticmethod(script)
    desktop.main()
    assert seen["status"].startswith("[neural] people=")
    assert seen["drew"]
