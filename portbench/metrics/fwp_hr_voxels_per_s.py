"""fwp_hr_voxels_per_s: high-res voxels (cells of every cropped chunk
output of every pass) completed in the window, over the window's wall
time."""


def read(record):
    if record.get('kind') != 'fwp':
        return None
    return record['hr_voxels'] / record['window_s']
