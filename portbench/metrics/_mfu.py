"""Shared by the ``mfu.*`` readers: the model's operations done in the
window outside its profiled stretch (counted from the layer lists at the
shapes run) over the window's seconds outside the stretch, as a share of
the card's fastest fp32-accurate rate (dense TF32 over three, 3xTF32)."""

from portbench.reference.peaks import fp32_accurate_peak


def mfu(record, kind):
    if record.get('kind') != kind or record['device_name'] == 'cpu':
        return None
    peak = fp32_accurate_peak(record['device_name'])
    return 100.0 * record['flops'] / record['flops_s'] / peak
