"""The cell `scannetpp.orbit` finds its configuration, traffic and limits
by name, and its configuration names under `reduced` only groups that the
merged `config` holds."""
import math

from perfbench.harness import manifest


def test_scannetpp_orbit_finds_its_files():
    cell = manifest.find_cell("scannetpp.orbit")
    assert cell.chips == 1
    assert cell.config["name"] == "scannetpp"
    assert set(cell.config["reduced"]) <= set(cell.config["config"])
    assert cell.traffic == manifest.load_json(f"{manifest.BENCH_DIR}/traffic/orbit.json")
    # ground-truth poses committed as they come: float32 rounding, 0.01 mm
    assert cell.limits["rpe_mm"] == cell.limits["ate_mm"] == 0.01
    # the map and the model view, each limit between the sound readings and
    # those of the map's parameters rounded to bfloat16 each frame
    assert {"map_mm", "view_mm", "view_color_levels", "view_color_dssim"} <= set(cell.limits)
    assert all(math.isfinite(v) and v > 0 for v in cell.limits.values())
