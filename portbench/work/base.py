"""The interface every kind of work keeps, and what they share: the program's
Config and model from a configuration file, and the seeded weights.

A work object owns one cell's work. ``setup`` builds the program's objects and
warms every shape the traffic uses; ``unit`` runs one unit of the timed
work and returns when it has finished on the device; ``end_to_end``
reduces the window to the cell's end-to-end metrics; ``counters`` gives
what the per-layer readers count; ``release`` frees the program's state;
``check`` compares what the window produced with the plain reference and
returns the numbers compared; ``late_counters`` then gives the counts
that need what the check worked out.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import torch

from portbench.reference.logmel import track_segments
from portbench.yardstick.traffic import music_like_on_device, seed_words
from portbench.yardstick.weights import calibrate, make_weights


class Work:
    unit_span = "pb.unit"

    def __init__(self, conf: dict, traffic: dict, seed: int, device: torch.device,
                 spans, workdir: str, fault: Optional[str] = None, control: bool = False):
        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.cfg = conf["config"]
        self.device, self.spans, self.workdir = device, spans, workdir
        self.fault, self.control = fault, control
        self.ref = importlib.import_module(f"portbench.reference.{conf['reference']}")
        # the correctness control of this kind of cell (configuration file)
        self.control_spec = conf["control"][traffic["kind"]]
        self.units = 0

    # -- the interface ----------------------------------------------------------
    def setup(self) -> None:
        raise NotImplementedError

    def unit(self) -> None:
        raise NotImplementedError

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        raise NotImplementedError

    def counters(self) -> Dict[str, float]:
        return {"units": self.units}

    def late_counters(self, first: int, last: int) -> Dict[str, float]:
        """Counters of units first..last-1 that need what ``check`` works
        out (the reference's cells, say); read after it."""
        return {}

    def release(self) -> None:
        raise NotImplementedError

    def check(self) -> List[dict]:
        raise NotImplementedError

    # -- shared -------------------------------------------------------------------
    def program_config(self, **changes):
        from grafp_tpu_torch.core.config import config_from_dict
        return config_from_dict({**self.cfg, **changes})

    def seeded_weights(self) -> Dict[str, torch.Tensor]:
        """The configuration's weights in the program's state_dict names:
        drawn on the device from its ``weights_seed``, calibrated by the
        reference on the first ``calibration_rows`` segments of music-like
        tracks drawn from the same seed. The same for every run: the
        fused kernels' selection costs more or less with the weights (up
        to 10 % of a build's rate from one seed's weights to another's on
        an H100), and the run's seed draws the traffic alone."""
        from grafp_tpu_torch.models.simclr import build_model
        seed = int(self.conf["weights_seed"])
        rows = int(self.conf["calibration_rows"])
        flat, lens = music_like_on_device(rows // 200 + 1, 20.0, 30.0, int(self.cfg["fs"]),
                                          seed_words(seed, 5), self.device)
        tracks = torch.split(flat, lens.tolist())
        spec = torch.cat([track_segments(w, self.cfg) for w in tracks])[:rows]
        template = build_model(self.program_config(), device="cpu").state_dict()
        sd = make_weights(template, seed, self.device)
        calibrate(sd, self.ref, spec, self.cfg)
        return sd
