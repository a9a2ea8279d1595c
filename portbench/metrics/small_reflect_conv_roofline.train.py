"""small_reflect_conv_roofline.train: ``small_reflect_conv_kernel``'s
share of its roofline at the training step's tail launch."""

from portbench.metrics._roofline import roofline


def read(record):
    return roofline(record, 'train', 'small_reflect_conv_kernel')
