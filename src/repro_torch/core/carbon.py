"""CARBON — carbon-intensity scoring agent (paper Sec IV extensibility
claim + Sec XIV "Environmental Optimization" future work, implemented).

The paper asserts that adding a new objective requires only (1) an agent
exposing a scoring function f(r, i_j) in [0,1] (lower = better), (2)
registration with WAVES, (3) automatic incorporation into Eq. (1). This
module is that agent: per-island grid carbon intensity with a diurnal solar
curve for renewable-backed islands; WAVES.register_agent wires it in with a
user weight, without any router code changes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

# gCO2e/kWh reference grid intensities
GRID_INTENSITY = {
    "solar": 40.0, "hydro": 25.0, "eu": 230.0, "us": 380.0,
    "coal_heavy": 700.0, "unknown": 475.0,
}
MAX_INTENSITY = 800.0


@dataclass
class CarbonAgent:
    """Scores islands by expected gCO2e per request."""
    # island_id -> (grid, watts_per_request)
    profiles: dict = field(default_factory=dict)
    clock_h: float = 12.0  # hour of day (drives the solar curve)

    def register_island(self, island_id: str, grid: str = "unknown",
                        watts: float = 50.0):
        self.profiles[island_id] = (grid, watts)

    def advance(self, hours: float):
        self.clock_h = (self.clock_h + hours) % 24.0

    def intensity(self, island) -> float:
        grid, watts = self.profiles.get(island.island_id,
                                        ("unknown", 50.0))
        g = GRID_INTENSITY[grid]
        if grid == "solar":
            # diurnal curve: solar islands fall back to grid mix at night
            sun = max(0.0, math.sin(math.pi * (self.clock_h - 6.0) / 12.0))
            g = sun * GRID_INTENSITY["solar"] + (1 - sun) * GRID_INTENSITY["us"]
        return g * watts  # ~ gCO2e h/kWh * W ∝ gCO2e per unit work

    def score(self, request, island) -> float:
        """Agent interface (Sec IV-C): [0,1], lower is better."""
        worst = MAX_INTENSITY * 300.0
        return min(self.intensity(island) / worst, 1.0)
