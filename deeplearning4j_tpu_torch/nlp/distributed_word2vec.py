"""Distributed Word2Vec: the dl4j-spark-nlp equivalent over the port's mesh.

Counterpart of deeplearning4j_tpu/nlp/distributed_word2vec.py (parity
surface: the reference's spark/dl4j-spark-nlp Word2Vec.java, executors
training local tables on their partitions and the master averaging them,
ParameterAveragingTrainingMaster's semantics).

Each slot of the mesh (exec/mesh.py; ``parallel.wrapper.default_mesh``
when none is given) keeps its own copy of (syn0, syn1neg) on its device.
Every batch of ``bs`` pairs is split column-wise over the slots; each slot
runs ``averaging_frequency`` per-pair skip-gram NEG batches on its copy,
then the copies are averaged (summed over a rank's slots, over the
process group when the mesh spans ranks, divided by the slot count) and
every copy restarts from the average: the JAX package's per-chunk
``pmean``. Each slot draws its negatives from its own generator (the JAX
package folds the slot's axis index into its key). With one slot the
average is the identity.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.exec.mesh import Mesh
from deeplearning4j_tpu_torch.nlp.word2vec import (
    Word2Vec, _draw_negatives, _sg_neg_batch)
from deeplearning4j_tpu_torch.parallel.distributed import topology


class DistributedWord2Vec(Word2Vec):
    """Word2Vec trained data-parallel over a mesh of slots (parity: the
    Spark Word2Vec). Only skip-gram with negative sampling: the
    configuration the reference's Spark implementation optimizes for."""

    def __init__(self, *args, mesh: Optional[Mesh] = None,
                 averaging_frequency: int = 8, scale_lr: bool = True,
                 **kwargs):
        kwargs.setdefault("elements_learning_algorithm", "skipgram")
        super().__init__(*args, **kwargs)
        if self.use_hs or self.algorithm != "skipgram":
            raise NotImplementedError(
                "DistributedWord2Vec supports skip-gram with negative "
                "sampling only (the configuration the reference's Spark "
                "implementation optimizes for)")
        if mesh is None:
            from deeplearning4j_tpu_torch.parallel.wrapper import default_mesh
            mesh = default_mesh(device=self.device)
        self.mesh = mesh
        self.averaging_frequency = max(1, averaging_frequency)
        # averaging n divergent replicas applies each local update at 1/n
        # weight; linear LR scaling restores the effective step size (the
        # classic data-parallel LR rule; disable with scale_lr=False)
        self.scale_lr = scale_lr

    def _average(self, reps):
        """Every local slot's (syn0, syn1) set to the mean over all slots
        of the mesh, in place; returns the mean on this model's device."""
        means = []
        for key in ("syn0", "syn1"):
            tot = torch.zeros_like(self.syn0)
            for r in reps:
                tot += r[key].to(self.device)
            if len(self.mesh.ranks) > 1:
                dist.all_reduce(tot)
            tot /= self.mesh.size
            for r in reps:
                r[key].copy_(tot)
            means.append(tot)
        return means

    def fit(self):
        if self.vocab is None:
            self.build_vocab()
        if self.syn0 is None:
            self._init_tables()
        seqs = self._encode_corpus()
        rng = np.random.RandomState(self.seed + 31)

        centers_all, contexts_all = self._make_pairs(seqs, rng)
        if len(centers_all) == 0:          # nothing to train on (all
            self._norm_cache = None        # sequences < 2 tokens)
            return self
        n_dev = self.mesh.size
        k = self.averaging_frequency
        bs = max(n_dev, self._effective_batch() // n_dev * n_dev)
        lb = bs // n_dev
        n_pairs = len(centers_all)
        steps_per_epoch = max(1, (n_pairs + bs - 1) // bs)
        # pad each epoch to C chunks of K batches of bs pairs (pad weight 0);
        # the LR schedule counts the k-rounded S steps, or later epochs
        # would start past total_steps and clamp to min_learning_rate
        C = (steps_per_epoch + k - 1) // k
        S = C * k
        total_steps = self.epochs * S

        # this rank's slots: a copy of the tables each, its batch columns
        # and its own negatives' generator
        rank, _ = topology()
        reps = [{"syn0": self.syn0.to(s.device, copy=True),
                 "syn1": self.syn1.to(s.device, copy=True),
                 "table": self._table.to(s.device), "device": s.device,
                 "cols": slice(g * lb, (g + 1) * lb),
                 "gen": torch.Generator(device=s.device).manual_seed(
                     self.seed * 1000 + g)}
                for g, s in enumerate(self.mesh.slots) if s.rank == rank]
        step_i = 0
        for ep in range(self.epochs):
            order = rng.permutation(n_pairs)
            pad = S * bs - n_pairs
            sel = np.concatenate([order, np.zeros(pad, order.dtype)])
            w = np.concatenate([np.ones(n_pairs, np.float32),
                                np.zeros(pad, np.float32)])
            lr0 = self.learning_rate * (n_dev if self.scale_lr else 1)
            lrs = np.maximum(
                self.min_learning_rate,
                lr0 * (1.0 - (step_i + np.arange(S)) / total_steps)
            ).astype(np.float32)
            host = (centers_all[sel].astype(np.int64).reshape(S, bs),
                    contexts_all[sel].astype(np.int64).reshape(S, bs),
                    w.reshape(S, bs))
            batches = [[torch.from_numpy(np.ascontiguousarray(
                a[:, r["cols"]])).to(r["device"]) for a in host]
                + [torch.from_numpy(lrs).to(r["device"])] for r in reps]
            for chunk in range(C):
                for r, (c, t, wt, lr) in zip(reps, batches):
                    for s in range(chunk * k, (chunk + 1) * k):
                        draw = _draw_negatives(r["gen"], (lb, self.negative),
                                               r["table"].shape[0],
                                               r["device"])
                        _sg_neg_batch(r["syn0"], r["syn1"], r["table"], c[s],
                                      t[s], lr[s], draw, weights=wt[s])
                self.syn0, self.syn1 = self._average(reps)
            step_i += S
        self._norm_cache = None
        return self
