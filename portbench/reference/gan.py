"""One GAN training step, as sup3r's ``Sup3rGan`` defines it, in plain
PyTorch: the generator on the low-res batch, the discriminator on the
real and on the generated high-res batch, the content loss (mean
absolute error) plus the weighted relativistic-average adversarial
loss for the generator, the relativistic-average loss for the
discriminator, and an Adam update of each network (optax's Adam:
``mu_hat / (sqrt(nu_hat) + eps)``)."""

import torch

from portbench.reference.network import apply


def sigmoid_bce(logits, labels):
    """Sigmoid cross entropy with logits, elementwise."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def relativistic_loss(out_a, out_b):
    """ESRGAN's relativistic-average loss that labels ``out_a`` real and
    ``out_b`` fake; the discriminator's loss is (true, generated), the
    generator's adversarial loss (generated, true)."""
    a = out_a - torch.mean(out_b)
    b = out_b - torch.mean(out_a)
    logits = torch.cat([a, b], dim=0)
    labels = torch.cat([torch.ones_like(a), torch.zeros_like(b)], dim=0)
    return torch.mean(sigmoid_bce(logits, labels))


class Adam:
    """Adam with optax's defaults and update rule."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, params, grads):
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))


def to_cf(x):
    """Channels-last batch -> channels-first."""
    return x.movedim(-1, 1)


def gan_step(gen, disc, lr, hr, weight_adv):
    """One step. ``gen`` / ``disc`` are dicts with 'layers', 'params'
    (leaf tensors that require grad) and 'opt' (an ``Adam``); ``lr`` and
    ``hr`` channels-last float32 batches. Returns (generator loss,
    discriminator loss, generator grads, discriminator grads) before the
    updates, and applies both updates."""
    out = apply(gen['layers'], gen['params'], to_cf(lr))
    hr_cf = to_cf(hr)
    d_true = apply(disc['layers'], disc['params'], hr_cf)
    d_gen = apply(disc['layers'], disc['params'], out)
    content = torch.mean(torch.abs(out - hr_cf))
    gen_loss = content + weight_adv * relativistic_loss(d_gen, d_true)
    disc_loss = relativistic_loss(d_true, d_gen)
    g_grads = torch.autograd.grad(gen_loss, gen['params'],
                                  retain_graph=True)
    d_grads = torch.autograd.grad(disc_loss, disc['params'])
    gen['opt'].update(gen['params'], g_grads)
    disc['opt'].update(disc['params'], d_grads)
    return (gen_loss.item(), disc_loss.item(), [g.detach() for g in g_grads],
            [g.detach() for g in d_grads])


def coarsen(hr, s_enhance, t_enhance):
    """sup3r's training pair: the low-res batch as the mean of each
    ``s_enhance`` x ``s_enhance`` block of the high-res one, then every
    ``t_enhance``-th time step from the first ('subsample')."""
    n, s1, s2, t, f = hr.shape
    lr = hr.reshape(n, s1 // s_enhance, s_enhance, s2 // s_enhance,
                    s_enhance, t, f).mean(dim=(2, 4))
    return lr[:, :, :, ::t_enhance]
