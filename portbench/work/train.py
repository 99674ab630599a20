"""SimCLR training: steps of the program's ``make_train_step`` at
``pairs`` pairs (a 2 x pairs stacked forward), each pair two 1-s crops
of one seeded music-like track at most ``offset`` apart, cut as the
program's ``FingerprintDataset`` cuts them; the step augments the second
view from banks of seeded noise clips and impulse responses. A pool of
``pool_batches`` batches lives on the card and is cycled; step s draws
from a generator seeded from the run's seed and s. Adam with the
configuration's schedule. One unit is one step. Closed loop.

Correctness: set-up builds one train state and drives it through its
first ``check_steps`` steps by the same call and feed as the window, on
distinct batches, then hands it to the window. The reference follows
those steps from the same weights, clips and draws. Compared: each
step's loss, the first gradient (as Adam's first moment holds it after
one step), and each parameter's change over the checked steps, the last
two by the worst leaf.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List

import torch

from portbench.work.base import Work
from portbench.reference import augment as ref_augment
from portbench.reference import train as ref_train
from portbench.reference.ops import Precision
from portbench.yardstick.traffic import music_like_on_device, seed_words, synthetic_clips

# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone under Adam, and are left out of the change
STILL_LEAF = 1e-3


class Train(Work):

    def setup(self) -> None:
        from grafp_tpu_torch.dsp.augment import AugmentBanks
        from grafp_tpu_torch.models.simclr import build_model
        from grafp_tpu_torch.train.state import create_train_state
        from grafp_tpu_torch.train.step import make_train_step

        t, fs = self.traffic, int(self.cfg["fs"])
        self.pairs = int(t["pairs"])
        with self.spans("setup.crops"):
            self.x_i, self.x_j = self.crops()
        with self.spans("setup.banks"):
            self.clips = synthetic_clips(fs, seed_words(self.seed, 3),
                                         int(t["noise_clips"]), int(t["irs"]))
            banks = AugmentBanks.from_arrays(noise_clips=self.clips[0], ir_clips=self.clips[1],
                                             noise_len=2 * fs, ir_len=2 * fs)
        with self.spans("setup.weights"):
            self.sd = self.seeded_weights()
        pcfg = self.program_config()
        with self.spans("setup.state"):
            model = build_model(pcfg, device="cpu", train=True)
            model.load_state_dict(self.sd)
            model.to(self.device)
            self.trainable = [n for n, _ in model.named_parameters()]
            self.steps_per_epoch = int(t["steps_per_epoch"])
            self.state = create_train_state(model, pcfg, steps_per_epoch=self.steps_per_epoch)
            self.step = make_train_step(model, pcfg, banks, device=self.device)
        if self.fault == "state_unchanged":
            self.state.optimizer.step = lambda *a, **k: None
        self.losses, self.first_grad = [], None
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        for s in range(int(t["check_steps"])):
            with self.spans("setup.checked_step"):
                self.losses.append(self.run_step(s))
            if s == 0:
                params = dict(model.named_parameters())
                moments = self.state.optimizer.state
                self.first_grad = {n: (moments[params[n]]["exp_avg"] / (1 - beta1)).clone()
                                   if params[n] in moments else torch.zeros_like(params[n])
                                   for n in self.trainable}
        self.after = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.done = int(t["check_steps"])

    def crops(self):
        """(pool_batches, pairs, clip) x_i and x_j on the device: for each
        pair a track of the pool, a region of clip + offset samples in it,
        and two clips at independent starts in the region, as the
        program's ``FingerprintDataset`` cuts them; every draw from the
        seed, on the device."""
        t, fs = self.traffic, int(self.cfg["fs"])
        flat, lens = music_like_on_device(int(t["tracks"]), float(t["lo_s"]), float(t["hi_s"]),
                                          fs, seed_words(self.seed, 1), self.device)
        g = torch.Generator(device=self.device).manual_seed(seed_words(self.seed, 2))
        clip = int(fs * float(self.cfg["dur"]))
        span = int(fs * float(self.cfg["offset"]) + clip)
        n = int(t["pool_batches"]) * self.pairs
        track = torch.randint(0, len(lens), (n,), generator=g, device=self.device)
        room = (lens[track] - span).to(torch.float64)
        start = lens.cumsum(0)[track] - lens[track]
        r = start + (torch.rand(n, generator=g, device=self.device, dtype=torch.float64)
                     * room).long()
        ri, rj = (torch.randint(0, span - clip, (2, n), generator=g, device=self.device))
        at = torch.arange(clip, device=self.device)
        shape = (int(t["pool_batches"]), self.pairs, clip)
        return (flat[(r + ri)[:, None] + at].view(shape).contiguous(),
                flat[(r + rj)[:, None] + at].view(shape).contiguous())

    def generator(self, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed_words(self.seed, 100 + step))

    def run_step(self, s: int) -> float:
        b = s % self.x_i.shape[0]
        x_i, x_j = self.x_i[b], self.x_j[b]
        if self.fault == "half_batch":
            x_i, x_j = x_i[:self.pairs // 2], x_j[:self.pairs // 2]
        with self.spans("train_step"):
            out = self.step(self.state, x_i, x_j, self.generator(s))
            return float(out["loss"])

    def unit(self) -> None:
        self.run_step(self.done + self.units)
        self.units += 1

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"train_pairs_per_s": self.pairs * self.units / window_s}

    def counters(self) -> Dict[str, float]:
        return {"units": self.units, "pairs": self.pairs * self.units}

    def release(self) -> None:
        del self.step, self.state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> List[dict]:
        n = int(self.traffic["check_steps"])
        fs = int(self.cfg["fs"])
        banks = ref_augment.Banks(*self.clips, 2 * fs, 2 * fs, self.device)
        batches = [(self.x_i[s], self.x_j[s]) for s in range(n)]

        def follow(precision: str) -> dict:
            return ref_train.train_steps(self.sd, batches, [self.generator(s) for s in range(n)],
                                         banks, self.cfg, self.steps_per_epoch,
                                         Precision(precision), self.trainable)

        ref = follow("f32")
        if self.control:
            got = follow(self.control_spec["precision"])
            losses, grads, after = got["losses"], got["first_grad"], got["params"]
        else:
            losses, grads, after = self.losses, self.first_grad, self.after

        def norm(t):
            return float(torch.linalg.vector_norm(t.double()))

        g_ref = {k: norm(ref["first_grad"][k]) for k in self.trainable}
        g_med = statistics.median(g_ref.values())
        moved = [k for k in self.trainable if g_ref[k] >= STILL_LEAF * g_med]
        d_ref = {k: norm(ref["params"][k] - self.sd[k]) for k in moved}
        d_med = statistics.median(d_ref.values())
        grad_gap = max(abs(norm(grads[k]) - g_ref[k]) / max(g_ref[k], g_med)
                       for k in self.trainable)
        update_gap = max(abs(norm(after[k] - self.sd[k]) - d_ref[k]) / max(d_ref[k], d_med)
                         for k in moved)
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
        still = sorted(set(self.trainable) - set(moved))
        print(f"losses {losses}, reference {ref['losses']}; {len(still)} leaves left out "
              f"of the change: {still}", file=sys.stderr)
        return [{"name": "loss_gap", "value": loss_gap},
                {"name": "grad_gap", "value": grad_gap},
                {"name": "update_gap", "value": update_gap}]
