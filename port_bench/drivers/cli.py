"""Serving cells: one caller runs the program's inference CLI
(``cli/run.py``, ``cli_entry``: argument parsing, checkpoint load, parse,
featurise, model calls, output files) on one structure after another, a
closed loop, as pipelines and checkpoint sweeps call it.

Set-up draws the weights on the card and writes them as a reference
checkpoint, writes the mix's structures as PDB files, and runs the largest
structure once. The answers judged are what each request produced: the
sampler's tokens, decode orders and log-probabilities as ``sample`` returned
them, the specificity ``.npz`` and the score ``.pt`` files as written.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import traffic, weights
from . import worst
from ..reference import model as M
from ..reference import structure
from ..reference import tokens as T


def draw_terms(lq, S, designed):
    """(sum over the designed positions of ``log q(served) - E_q[log q]``,
    sum of ``Var_q[log q]``), with ``lq`` ``[B, L, 33]`` the reference's log
    sampling distribution along the served tokens ``S`` and order. Where the
    served letters are drawn from ``q``, each term has mean 0 given the
    tokens before it."""
    q = lq.exp()
    qlq = torch.where(q > 0, q * lq, torch.zeros_like(q))
    mean = qlq.sum(-1)
    var = (torch.where(q > 0, qlq * lq, torch.zeros_like(q)).sum(-1) - mean ** 2).clamp(min=0)
    served = torch.gather(lq, -1, S[..., None])[..., 0]
    return torch.stack([(served - mean)[:, designed].sum(), var[:, designed].sum()])


def draw_z(terms):
    """How far the served letters lie from draws of the reference's
    sampling distribution, in standard errors: ``|sum| / sqrt(sum of
    variances)`` (about |N(0, 1)| for a sound sampler; large where it draws
    at another temperature, takes the likeliest letter or an omitted one)."""
    num, var = float(terms[0]), float(terms[1])
    if num != num or var <= 0:
        return 0.0 if num == 0 else float("inf")
    return abs(num) / var ** 0.5


class Driver:
    # wait for the card after each request (a request's time is its own)
    sync_each = True

    def __init__(self, cell):
        self.cell = cell
        self.mix = cell.mix
        self.mode = self.mix["argv"][self.mix["argv"].index("--mode") + 1]
        self.served = {}         # request -> the sampler's outputs
        self.paths, self.lengths = [], []
        self.current = None

    # -- set-up ------------------------------------------------------------

    def setup(self):
        from na_mpnn_tpu_torch.cli import run as cli
        from na_mpnn_tpu_torch.models import mpnn

        cell = self.cell
        self.cli = cli
        self.sd = weights.make(cell.config, cell.seed, cell.device)
        self.checkpoint = os.path.join(cell.out, "weights.pt")
        weights.save(self.sd, self.checkpoint)
        self.pool = pool = traffic.structure_pool(self.mix, cell.seed)
        os.makedirs(os.path.join(cell.out, "pdb"), exist_ok=True)
        for i, chains in enumerate(pool):
            path = os.path.join(cell.out, "pdb", f"s{i}.pdb")
            self.lengths.append(traffic.write_pdb(path, chains, cell.seed, i))
            self.paths.append(path)
        self.seeds = traffic.rng_for(cell.seed, 5).integers(1, 2 ** 31 - 1, size=len(pool))
        if self.mode != "score":
            self._sample = mpnn.sample

            def capture(*args, **kwargs):
                out = self._sample(*args, **kwargs)
                self.served.setdefault(self.current, []).append(out)
                return out
            mpnn.sample = capture
        # the largest structure once: allocations and every library handle
        self.request(-1, int(np.argmax(self.lengths)))
        self.served.pop(-1, None)

    def restore(self):
        if self.mode != "score":
            from na_mpnn_tpu_torch.models import mpnn
            mpnn.sample = self._sample

    # -- the window ----------------------------------------------------------

    def folder(self, i):
        return os.path.join(self.cell.out, "req", str(i))

    def request(self, i, j=None):
        j = i % len(self.paths) if j is None else j
        self.current = i
        self.cli.cli_entry(self.mix["argv"] + [
            "--checkpoint_na_mpnn", self.checkpoint, "--pdb_path", self.paths[j],
            "--out_folder", self.folder(i), "--seed", str(int(self.seeds[j])),
            "--device", self.cell.device])
        return {"structure": j, "residues": self.lengths[j],
                "chains": self.pool[j]}

    def release(self):
        """Nothing of the program is held after the window but the served
        outputs; the caching allocator's blocks go back to the card."""
        if self.cell.device != "cpu":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------

    def checked(self, requests):
        """A sample of the finished requests drawn from the seed, the longest
        first, until ``check.tokens`` answers or ``check.requests``."""
        done = [i for i, r in enumerate(requests) if r["ok"]]
        if not done:
            return []
        longest = max(done, key=lambda i: requests[i]["residues"])
        rest = [i for i in traffic.rng_for(self.cell.seed, 8).permutation(done)
                if i != longest]
        picked, tokens = [longest], 0
        rows = self.cell.config["inference"][self.mode]["batch_size"]
        for i in [longest] + rest:
            if i != longest:
                if tokens >= self.mix["check"]["tokens"] or \
                        len(picked) >= self.mix["check"]["requests"]:
                    break
                picked.append(i)
            tokens += requests[i]["residues"] * rows
        return picked

    def _structure(self, j):
        s = structure.read_pdb(self.paths[j])
        dev = self.cell.device
        batch = {k: torch.as_tensor(np.asarray(v))[None].to(dev)
                 for k, v in s.items() if k != "chain_letters"}
        batch["X"] = batch["X"].float()
        return batch

    def _encode(self, batch, prec):
        cfg = self.cell.config
        h_V, h_E, E_idx, att = M.features(self.sd, batch, cfg["NUM_NEIGHBORS"], prec)
        h_V, h_E = M.encoder(self.sd, h_V, h_E, E_idx, batch["mask"].float(), att, prec)
        return h_V, h_E, E_idx

    def _decode_rows(self, enc, batch, S, order, prec, block=8):
        h_V, h_E, E_idx = enc
        out = []
        for a in range(0, S.shape[0], block):
            n = min(block, S.shape[0] - a)
            out.append(M.decoder(self.sd, h_V.expand(n, -1, -1), h_E.expand(n, -1, -1, -1),
                                 E_idx.expand(n, -1, -1), batch["mask"].float().expand(n, -1),
                                 S[a:a + n], order[a:a + n], prec))
        return torch.cat(out)

    def check(self, requests, control=None):
        """The numbers compared, each (name, value): with ``control`` (a
        precision) the reference in that precision stands in for the
        program's answers (same prompts, tokens and orders)."""
        with torch.no_grad(), M.exact_float32():
            if self.mode == "score":
                return self._check_score(requests, control)
            return self._check_sampler(requests, control)

    def _omit(self):
        argv = self.mix["argv"]
        letters = argv[argv.index("--omit_AA") + 1] if "--omit_AA" in argv else "X"
        omit = torch.tensor([float(c in letters + "bdhuy") for c in T.ONE_LETTER],
                            device=self.cell.device)
        return omit

    def _check_sampler(self, requests, control):
        inf = self.cell.config["inference"][self.mode]
        fp32 = M.Precision("fp32")
        omit = self._omit()
        logp_gap = token_gap = ppm_gap = repeats = 0.0
        draw = torch.zeros(2, dtype=torch.float64, device=self.cell.device)
        for i in self.checked(requests):
            j = requests[i]["structure"]
            batch = self._structure(j)
            out = self.served[i][0]
            S, order = out["S"].long(), out["decoding_order"].long()
            enc = self._encode(batch, fp32)
            lp = self._decode_rows(enc, batch, S, order, fp32)
            designed = batch["mask"].float()
            if "--design_na_only" in self.mix["argv"]:
                designed = designed * (batch["dna_mask"] + batch["rna_mask"]).float()
            got = out["log_probs"].float()
            if control is not None:
                prec = M.Precision(control)
                got = self._decode_rows(self._encode(batch, prec), batch, S, order, prec)
            d = designed[0] > 0
            logp_gap = worst(logp_gap, (got - lp)[:, d].abs().max())
            q = M.sampling_probs(lp, inf["temperature"], omit)
            lq = torch.log(q)
            served = torch.gather(lq, -1, S[..., None])[..., 0]
            gap = (lq.max(-1).values - served)[:, d]
            token_gap = worst(token_gap, gap.max().clamp(max=1e30))
            draw += draw_terms(M.sampling_log_probs(lp, inf["temperature"], omit), S, d)
            repeats = worst(repeats, S.shape[0] - torch.unique(order, dim=0).shape[0])
            if self.mode != "specificity":
                continue
            npz = os.path.join(self.folder(i), "specificity",
                               os.path.basename(self.paths[j])[:-4] + ".npz")
            if not os.path.exists(npz):          # an answer never written
                ppm_gap = 1e30
                continue
            ppm = torch.as_tensor(np.load(npz)["predicted_ppm"], device=lp.device)
            if control is not None:
                qc = M.sampling_probs(got, inf["temperature"], omit)
                ppm = (designed[0, :, None] * qc).double().mean(0)
            want = (designed[0, :, None] * q).double().mean(0)
            ppm_gap = worst(ppm_gap, (ppm - want).abs().max())
        checks = [("logp_gap", logp_gap), ("token_gap", token_gap),
                  ("draw_z", draw_z(draw))]
        if self.mode == "specificity":
            checks += [("ppm_gap", ppm_gap), ("repeated_orders", repeats)]
        return checks

    def _check_score(self, requests, control):
        fp32 = M.Precision("fp32")
        logp_gap = uncond_gap = repeats = 0.0
        for i in self.checked(requests):
            j = requests[i]["structure"]
            batch = self._structure(j)
            stats = torch.load(os.path.join(self.folder(i), "stats",
                                            os.path.basename(self.paths[j])[:-4] + ".pt"),
                               weights_only=False)
            order = torch.as_tensor(np.asarray(stats["decoding_order"])).long().to(self.cell.device)
            S = batch["S"].long().expand(order.shape[0], -1)
            enc = self._encode(batch, fp32)
            lp = self._decode_rows(enc, batch, S, order, fp32)
            un = M.decoder(self.sd, *enc, batch["mask"].float(), None, None, fp32)[0]
            got = torch.as_tensor(np.asarray(stats["log_probs"])).float().to(lp.device)
            got_un = torch.as_tensor(np.asarray(stats["unconditional_log_probs"])).float().to(lp.device)
            if control is not None:
                prec = M.Precision(control)
                enc_c = self._encode(batch, prec)
                got = self._decode_rows(enc_c, batch, S, order, prec)
                got_un = M.decoder(self.sd, *enc_c, batch["mask"].float(), None, None, prec)[0]
            m = batch["mask"][0] > 0
            logp_gap = worst(logp_gap, (got - lp)[:, m].abs().max())
            uncond_gap = worst(uncond_gap, (got_un - un)[m].abs().max())
            repeats = worst(repeats, order.shape[0] - torch.unique(order, dim=0).shape[0])
        return [("logp_gap", logp_gap), ("uncond_gap", uncond_gap),
                ("repeated_orders", repeats)]
