"""Operations a model needs, counted from its layer list and shapes.

A convolution or dense layer of ``m`` multiply-adds counts ``2m``
operations forward, as many for the gradient of its input (dgrad) and
as many for the gradient of its weights (wgrad). A convolution that a
crop follows counts only the outputs the crop keeps: the published
models pad by 3, convolve and crop by 2, which is a reflect-padded
convolution of the input's own size, and the halo the crop drops is no
work of the model's. Padding, crops, activations, expansions and skips
count nothing. The count is of the model's work, so it reads the same
whatever implementation runs it.
"""

import math

from portbench.reference.network import CONV_CLASSES, walk_shapes


def layer_macs(layers, in_shape):
    """Multiply-adds of each conv / dense layer of one forward pass, in
    list order, for a channels-last input shape (batch included)."""
    macs = []
    walk = walk_shapes(layers, in_shape)
    for i, (layer, shape_in, shape_out) in enumerate(walk):
        cls = layer['class']
        following = walk[i + 1][0]['class'] if i + 1 < len(walk) else None
        if following in ('Cropping2D', 'Cropping3D'):
            shape_out = walk[i + 1][2]
        if cls in CONV_CLASSES:
            k = layer['kernel_size']
            n_k = (math.prod(k) if isinstance(k, (list, tuple))
                   else k ** (len(shape_in) - 2))
            macs.append(math.prod(shape_out[:-1]) * shape_out[-1]
                        * shape_in[-1] * n_k)
        elif cls == 'Dense':
            macs.append(math.prod(shape_out[:-1]) * shape_out[-1]
                        * shape_in[-1])
    return macs


def forward_flops(layers, in_shape):
    """Operations of one forward pass."""
    return 2 * sum(layer_macs(layers, in_shape))


def gan_step_flops(gen_layers, disc_layers, lr_shape, hr_shape):
    """Operations of one GAN step as the program runs it: the generator
    forward; the discriminator forward on the real and on the generated
    batch; the generator's loss back through the discriminator on the
    generated batch (dgrad of every layer) and through the generator
    (dgrad of every layer but the first, wgrad of every layer); the
    discriminator's loss back through both of its calls (dgrad of every
    layer but the first, wgrad of every layer)."""
    g = [2 * m for m in layer_macs(gen_layers, lr_shape)]
    d = [2 * m for m in layer_macs(disc_layers, hr_shape)]
    gen_fwd, disc_fwd = sum(g), sum(d)
    gen_back = (sum(g) - g[0]) + sum(g)
    disc_back_one = (sum(d) - d[0]) + sum(d)
    return (gen_fwd + 2 * disc_fwd + sum(d) + gen_back
            + 2 * disc_back_one)
