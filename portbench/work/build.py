"""The DB build: a pool of seeded music-like tracks, cycled in order in
chunks of ``pack`` tracks through ``FingerprintPipeline.fingerprint_tracks``,
every fingerprint appended through the program's ``MemmapWriter`` to a
memmap under the run's work directory, as ``create_dummy_db`` does. One
unit is one chunk: its fingerprints computed and written. Closed loop,
one stream.

Correctness: after the window, tracks drawn from the seed (the longest
among them) are read back from the memmap where the window wrote them
and held row by row against the plain reference's fingerprints of the
same audio (its own log-mel, segmentation and float32 model).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.work.base import Work
from portbench.reference.logmel import track_segments
from portbench.reference.ops import Precision, exact_float32
from portbench.yardstick.traffic import music_like_on_device, seed_words

REF_BATCH = 256
WINDOW_PASSES = 32    # passes over the pool the memmap holds before it grows


class Build(Work):

    def setup(self) -> None:
        from grafp_tpu_torch.fp.builder import FingerprintPipeline
        from grafp_tpu_torch.models.simclr import build_model
        from grafp_tpu_torch.retrieval.memmap_io import MemmapWriter

        t = self.traffic
        self.pack = int(t["pack"])
        with self.spans("setup.tracks"):
            flat, lens = music_like_on_device(int(t["tracks"]), float(t["lo_s"]), float(t["hi_s"]),
                                              int(self.cfg["fs"]), seed_words(self.seed, 1),
                                              self.device)
            self.pool = np.split(flat.cpu().numpy(), np.cumsum(lens.cpu().numpy())[:-1])
        self.chunks = [list(range(i, min(i + self.pack, len(self.pool))))
                       for i in range(0, len(self.pool), self.pack)]
        with self.spans("setup.weights"):
            sd = self.seeded_weights()
        # a control that is a path of the program runs the program with it on
        path = self.control_spec.get("program", {}) if self.control else {}
        pcfg = self.program_config(**path)
        with self.spans("setup.pipeline"):
            model = build_model(pcfg, device="cpu")
            missing, unexpected = model.load_state_dict(sd, strict=False)
            # a quantised path adds its activation maxima, which it calibrates itself
            if unexpected or any(not k.endswith(".amax") for k in missing):
                raise KeyError(f"weights do not fit the model: {missing} {unexpected}")
            self.sd = sd
            self.pipe = FingerprintPipeline(model, pcfg, batch_size=int(t["batch_size"]),
                                            bucket_s=float(t["bucket_s"]), device=self.device)
        self._count_embeds()
        with self.spans("setup.warm"):
            for c in self.warm_chunks():
                self.pipe.fingerprint_tracks([self.pool[i] for i in c], pack=self.pack)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        # the program's DB builders size the memmap for the whole catalogue
        # (fp/builder.py:_capacity), so it never grows, and flushes, mid-build;
        # the window's catalogue is the pool cycled, sized for WINDOW_PASSES
        per_pass = sum(self.true_rows(i) for i in range(len(self.pool)))
        self.writer = MemmapWriter(self.workdir, "portbench_db", int(self.cfg["d"]),
                                   capacity=max(per_pass * WINDOW_PASSES, 1024))
        self.rows = self.embedded = 0
        self.occurrences: Dict[int, List[tuple]] = {}

    def _count_embeds(self) -> None:
        """Count the rows of every model call of the pipeline (its
        ``embed``), and plant a fault there if one is asked for."""
        pipe, inner = self.pipe, self.pipe.embed
        self.embedded = 0

        def embed(spec):
            self.embedded += int(spec.shape[0])
            out = inner(spec)
            if self.fault == "alter_answer":
                out = out.clone()
                out[0] = -out[0]
            elif self.fault == "roll_rows":
                out = torch.roll(out, 1, dims=0)
            return out

        pipe.embed = embed

    def true_rows(self, i: int) -> int:
        from portbench.yardstick.traffic import true_segments
        return true_segments(len(self.pool[i]), self.cfg)

    def warm_chunks(self) -> List[list]:
        """Chunks that together hold every (tracks, bucket length) group the
        pool's chunks embed, so every shape of the window is warm."""
        from portbench.yardstick.traffic import bucket_samples
        bucket_s = float(self.traffic["bucket_s"])

        def groups(chunk):
            out, i = set(), 0
            while i < len(chunk):
                length = bucket_samples(len(self.pool[chunk[i]]), self.cfg, bucket_s)
                j = i
                while j < len(chunk) and bucket_samples(len(self.pool[chunk[j]]), self.cfg,
                                                        bucket_s) == length:
                    j += 1
                out.add((j - i, length))
                i = j
            return out

        seen, picked = set(), []
        for c in self.chunks:
            g = groups(c)
            if not g <= seen:
                picked.append(c)
                seen |= g
        return picked

    def unit(self) -> None:
        chunk = self.chunks[self.units % len(self.chunks)]
        with self.spans("fingerprint_tracks"):
            zs = self.pipe.fingerprint_tracks([self.pool[i] for i in chunk], pack=self.pack)
        with self.spans("memmap_append"):
            for i, z in zip(chunk, zs):
                if len(z):
                    self.occurrences.setdefault(i, []).append((self.writer.n, len(z)))
                    self.writer.append(z)
                self.rows += len(z)
        self.units += 1

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"fp_per_s": self.rows / window_s}

    def counters(self) -> Dict[str, float]:
        return {"units": self.units, "rows": self.rows, "embedded_rows": self.embedded}

    def release(self) -> None:
        self.writer.close()
        del self.pipe
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[dict]:
        """Sampled tracks' rows as written, each against the float32
        reference's row of the same segment: 1 - cos, its largest and its
        mean over the rows."""
        rs = np.random.RandomState(seed_words(self.seed, 7))
        seen = sorted(self.occurrences)
        longest = max(seen, key=lambda i: len(self.pool[i]))
        rest = [i for i in seen if i != longest]
        n = min(int(self.traffic["check_tracks"]) - 1, len(rest))
        picked = [longest] + [rest[j] for j in rs.choice(len(rest), n, replace=False)]
        mm = np.memmap(self.writer.path, dtype=np.float32, mode="r",
                       shape=(self.writer.n, int(self.cfg["d"])))
        gaps, count_diff = [], 0
        for i in picked:
            occ = self.occurrences[i]
            off, n_rows = occ[rs.randint(len(occ))]
            got = torch.as_tensor(np.array(mm[off:off + n_rows]), device=self.device)
            want = self.reference_rows(self.pool[i], Precision("f32"))
            if self.control and "precision" in self.control_spec:
                got = self.reference_rows(self.pool[i], Precision(self.control_spec["precision"]))
            count_diff += abs(len(got) - len(want))
            m = min(len(got), len(want))
            cos = torch.nn.functional.cosine_similarity(got[:m].double(), want[:m].double(),
                                                        dim=-1)
            gaps.append((1.0 - cos).cpu())
        del mm
        gap = torch.cat(gaps)
        return [{"name": "rows_count_diff", "value": int(count_diff)},
                {"name": "row_gap_max", "value": float(gap.max())},
                {"name": "row_gap_mean", "value": float(gap.mean())}]

    @torch.no_grad()
    def reference_rows(self, wave: np.ndarray, precision: Precision) -> torch.Tensor:
        segs = track_segments(torch.as_tensor(wave, device=self.device), self.cfg)
        with exact_float32():
            return torch.cat([self.ref.forward(self.sd, segs[i:i + REF_BATCH], self.cfg, precision)
                              for i in range(0, len(segs), REF_BATCH)])
