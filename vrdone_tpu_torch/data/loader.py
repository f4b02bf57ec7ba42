"""Host-side training data loader: shuffling, pair assembly, static packing
and background prefetch (counterpart of ``vrdone_tpu/data/loader.py``).

Epoch e shuffles with ``np.random.default_rng(seed + 1000 * e)``, the same
generator that then draws each item's pairs, so the port and the JAX
package give identical batches from one seed. A daemon thread packs up to
``prefetch`` batches ahead of the train step.

With ``process_count`` > 1 (data parallelism, ``parallel/mesh.py``) every
process derives the same shuffled order from the seed and packs only its
contiguous rows of each global batch: ``batch_size / process_count`` items
into ``pack_size / process_count`` pairs, as the JAX loader does.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from . import batching


class TrainLoader:
    def __init__(self, dataset, batch_size: int, pack_size: int,
                 max_seq_len: int, num_gt: int, feat_dim: int, seed: int = 42,
                 prefetch: int = 4, process_index: int = 0,
                 process_count: int = 1):
        assert batch_size % process_count == 0, (batch_size, process_count)
        assert pack_size % process_count == 0, (pack_size, process_count)
        self.ds = dataset
        self.batch_size = batch_size
        self.pack_size = pack_size
        self.max_seq_len = max_seq_len
        self.num_gt = num_gt
        self.feat_dim = feat_dim
        self.seed = seed
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count

    def steps_per_epoch(self) -> int:
        return self.ds.num_train_items() // self.batch_size

    def epoch(self, epoch: int):
        """Yields packed numpy batches for one epoch (shuffled, the last
        partial batch dropped): this process's rows of each global
        batch."""
        rng = np.random.default_rng(self.seed + 1000 * epoch)
        order = rng.permutation(self.ds.num_train_items())
        n_steps = self.steps_per_epoch()
        local_bs = self.batch_size // self.process_count
        local_pack = self.pack_size // self.process_count
        lo = self.process_index * local_bs

        def produce(q: queue.Queue):
            try:
                for step in range(n_steps):
                    start = step * self.batch_size + lo
                    pairs = []
                    for i in order[start:start + local_bs]:
                        pairs += self.ds.get_train_item(int(i), rng)
                    q.put(batching.pack_train_batch(
                        pairs, local_pack, self.max_seq_len,
                        self.num_gt, self.feat_dim))
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)
            q.put(None)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        threading.Thread(target=produce, args=(q,), daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item
