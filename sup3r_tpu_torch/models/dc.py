"""Sup3rGanDC: a data-centric GAN whose sampling weights adapt to the
validation loss of each spatiotemporal bin every epoch.

Reference parity: sup3r/models/dc.py:18-119. The port's copy of
``sup3r_tpu/models/dc.py``.
"""

import logging

import numpy as np
import torch

from sup3r_tpu_torch.models.gan import Sup3rGan
from sup3r_tpu_torch.parallel.mesh import all_reduce_
from sup3r_tpu_torch.utilities import exact_fp32

logger = logging.getLogger(__name__)


class Sup3rGanDC(Sup3rGan):
    """GAN with loss-adaptive spatiotemporal bin sampling."""

    _spatial_refusal = (
        "its per-bin validation losses are averaged over data-parallel ranks only")

    def calc_val_loss_gen(self, batch_handler, weight_gen_advers):
        """Per-bin (total, content) validation losses, each of shape
        (n_space_bins, n_time_bins). Batch ``i`` of the validation queue
        is bin (``i % n_s``, ``(i // n_s) % n_t``), the order in which
        ``ValBatchQueueDC`` emits them. With a mesh attached, each rank's
        losses of its own batches are averaged over the ranks."""
        n_s = batch_handler.n_space_bins
        n_t = batch_handler.n_time_bins
        total = np.zeros((n_s, n_t), dtype=np.float32)
        content = np.zeros((n_s, n_t), dtype=np.float32)
        net = self._train_gen_net()
        for i, batch in enumerate(batch_handler.val_data):
            lr = self._place_batch(batch.low_res)
            hr = self._place_batch(batch.high_res)
            with torch.no_grad(), exact_fp32():
                out = net.apply(lr, self._split_exo(hr))
            loss, details = self.calc_loss(
                hr, out, weight_gen_advers=weight_gen_advers,
                train_gen=True, compute_disc=True)
            vals = self._fetch_details({'loss': loss, **details})
            total[i % n_s, (i // n_s) % n_t] = vals['loss']
            content[i % n_s, (i // n_s) % n_t] = vals['loss_gen_content']
        if self._mesh is not None:
            both = [torch.from_numpy(total), torch.from_numpy(content)]
            all_reduce_(self._mesh, both, self._mesh_axis)
            n = self._mesh.shape[self._mesh_axis]
            total, content = (t.numpy() / n for t in both)
        return total, content

    def calc_val_loss(self, batch_handler, weight_gen_advers):
        """Push the normalized per-bin validation losses to the batch
        handler as its new bin weights (reference: dc.py:66-110)."""
        if not hasattr(batch_handler, 'update_weights') or len(
                batch_handler.val_data) == 0:
            return super().calc_val_loss(batch_handler, weight_gen_advers)
        total, content = self.calc_val_loss_gen(batch_handler,
                                                weight_gen_advers)
        t_weights = total.mean(axis=0)
        t_weights = t_weights / t_weights.sum()
        s_weights = total.mean(axis=1)
        s_weights = s_weights / s_weights.sum()
        batch_handler.update_weights(spatial_weights=s_weights,
                                     temporal_weights=t_weights)
        return {'val_loss_gen': float(total.mean()),
                'val_loss_gen_content': float(content.mean())}
