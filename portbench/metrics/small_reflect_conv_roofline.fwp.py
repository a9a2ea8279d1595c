"""small_reflect_conv_roofline.fwp: ``small_reflect_conv_kernel``'s
share of its roofline at the forward pass's tail launch."""

from portbench.metrics._roofline import roofline


def read(record):
    return roofline(record, 'fwp', 'small_reflect_conv_kernel')
