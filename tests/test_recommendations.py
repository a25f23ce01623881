"""Recommendations rule-cascade unit tests (utils/recommendations.py:1-190
threshold semantics)."""

from lidar_crowd.utils.recommendations import (
    generate_recommendations)


def _density(hotspots=(), avg=0.0):
    return {"hotspots": list(hotspots), "avg_density": avg,
            "total_people": 10, "max_density": 0.0}


def _flow(bottlenecks=(), speed=1.0, direction="NE"):
    return {"bottlenecks": list(bottlenecks), "avg_speed": speed,
            "dominant_direction": direction}


def test_critical_hotspot_rules():
    r = generate_recommendations(
        _density([{"x": 1.0, "y": 2.0, "density": 4.5}]), _flow())
    assert r["issues"][0]["title"].startswith("Critical crowd density")
    assert r["issues"][0]["severity"] == min(10, int(4.5 * 2))  # == 9
    assert r["actions"][0]["priority"] == "High"
    assert len(r["actions"][0]["steps"]) == 4


def test_high_hotspot_rules():
    r = generate_recommendations(
        _density([{"x": 0.0, "y": 0.0, "density": 2.5}]), _flow())
    assert r["issues"][0]["title"].startswith("High crowd density")
    assert r["issues"][0]["severity"] == min(8, int(2.5 * 2))  # == 5
    assert r["actions"][0]["priority"] == "Medium"


def test_low_hotspot_no_issue():
    r = generate_recommendations(
        _density([{"x": 0.0, "y": 0.0, "density": 1.5}]), _flow())
    assert r["issues"] == []


def test_venue_density_rule():
    r = generate_recommendations(_density(avg=3.0), _flow())
    titles = [i["title"] for i in r["issues"]]
    assert "Overall crowd density too high" in titles
    assert r["issues"][0]["severity"] == min(9, 6)


def test_bottleneck_severity_bands():
    r = generate_recommendations(_density(), _flow(
        [{"x": 0, "y": 0, "severity": 8},
         {"x": 1, "y": 1, "severity": 5},
         {"x": 2, "y": 2, "severity": 3}]))
    titles = [i["title"] for i in r["issues"]]
    assert titles[0].startswith("Critical flow bottleneck")
    assert titles[1].startswith("Flow bottleneck")
    assert len(titles) == 2  # severity-3 bottleneck below threshold


def test_slow_flow_rule():
    r = generate_recommendations(_density(), _flow(speed=0.3))
    assert r["issues"][0]["title"] == "Slow overall crowd movement"
    assert r["issues"][0]["severity"] == min(7, int((0.7 - 0.3) * 10))


def test_opportunities_always_present_with_direction():
    r = generate_recommendations(_density(), _flow(direction="SW"))
    assert len(r["opportunities"]) == 4
    assert any("SW" in o["description"] for o in r["opportunities"])
