"""RCA-GAN loss stack (paper_gan.py:202-287).

Counterpart of ``vub_image_denoising_tpu/train/gan_losses.py``, on NCHW:

- perceptual: MSE between VGG19 features[:8] of the two images;
- texture: MSE between gram matrices of the images, flattened (N*C, H*W),
  G = f f^T / (N*C*H*W);
- content: sqrt(L1^2 + 1e-8);
- WGAN-GP: mean(D(fake)) - mean(D(real)) + lambda_gp * mean((||grad D(xhat)||_2
  - 1)^2) at xhat = eps*real + (1-eps)*fake, eps ~ U(0, 1) per sample; the
  inner gradient is ``torch.autograd.grad(..., create_graph=True)``, so the
  penalty is differentiable for the G step;
- multimodal: lambda1*perceptual + lambda2*content + lambda3*texture
  + lambda4*adversarial.

``eps`` is drawn from ``generator`` unless it is given (the tests hand over
JAX's draws).

The texture and content terms are not means of per-sample terms (the gram
matrix spans the batch; the square root is of the batch's L1).  Under data
parallelism (``batch_group``: the data axis's process group) they are taken
over the global batch, as GSPMD takes them in JAX: the features are
all-gathered (``parallel.mesh.all_gather_rows``) and the L1 summed over the
ranks, each rank's loss being the global term, whose gradient the
collectives' backward sums over the ranks.
"""

import torch


def perceptual_loss(vgg, real, generated):
    """MSE between VGG features; argument order as the reference's call
    perceptual_loss(real_images, generated_images) (paper_gan.py:281)."""
    return torch.mean((vgg(real) - vgg(generated)) ** 2)


def gram_matrix(x):
    a, b, c, d = x.shape
    f = x.reshape(a * b, c * d)
    return (f @ f.t()) / (a * b * c * d)


def texture_loss(generated, real, batch_group=None):
    if batch_group is not None:
        from ..parallel.mesh import all_gather_rows

        generated, real = all_gather_rows(generated, batch_group), all_gather_rows(real, batch_group)
    return torch.mean((gram_matrix(generated) - gram_matrix(real)) ** 2)


def content_loss(generated, real, batch_group=None):
    l1 = torch.mean(torch.abs(generated - real))
    if batch_group is not None:
        from ..parallel.mesh import all_reduce_sum_autograd, group_size

        l1 = all_reduce_sum_autograd(l1, batch_group) / group_size(batch_group)
    return torch.sqrt(l1 ** 2 + 1e-8)


def draw_eps(real, generator=None):
    """The penalty's per-sample interpolation weights, U(0, 1), (N, 1, 1, 1)."""
    return torch.rand((real.shape[0], 1, 1, 1), generator=generator, device=real.device,
                      dtype=real.dtype)


def input_gradient_norms(d_apply, z, create_graph=True):
    """||d sum(D(z)) / dz||_2 per sample, + 1e-12 under the root."""
    if not z.requires_grad:
        z = z.detach().requires_grad_(True)
    with torch.enable_grad():
        grads, = torch.autograd.grad(d_apply(z).sum(), z, create_graph=create_graph)
    return torch.sqrt(torch.sum(grads.reshape(z.shape[0], -1) ** 2, dim=1) + 1e-12)


def gradient_penalty(d_apply, real, fake, eps=None, generator=None, lambda_gp=10.0,
                     create_graph=True):
    """WGAN-GP (paper_gan.py:240-260)."""
    eps = draw_eps(real, generator) if eps is None else eps
    norms = input_gradient_norms(d_apply, eps * real + (1 - eps) * fake, create_graph)
    return lambda_gp * torch.mean((norms - 1.0) ** 2)


def wgan_adversarial(d_apply, real, fake, eps=None, generator=None, lambda_gp=10.0,
                     create_graph=True):
    """mean(D(fake)) - mean(D(real)) + GP (paper_gan.py:262-267)."""
    d_real = torch.mean(d_apply(real))
    d_fake = torch.mean(d_apply(fake))
    gp = gradient_penalty(d_apply, real, fake, eps, generator, lambda_gp, create_graph)
    return d_fake - d_real + gp


def multimodal_loss(vgg, d_apply, generated, real, eps=None, generator=None,
                    lambda1=1.0, lambda2=0.01, lambda3=0.001, lambda4=1.0, lambda_gp=10.0,
                    create_graph=True, batch_group=None):
    """The generator's objective (paper_gan.py:280-287); returns (total, parts)."""
    l_percep = perceptual_loss(vgg, real, generated)
    l_content = content_loss(generated, real, batch_group)
    l_texture = texture_loss(generated, real, batch_group)
    l_adv = wgan_adversarial(d_apply, real, generated, eps, generator, lambda_gp, create_graph)
    total = lambda1 * l_percep + lambda2 * l_content + lambda3 * l_texture + lambda4 * l_adv
    return total, {"perceptual": l_percep, "content": l_content, "texture": l_texture,
                   "adversarial": l_adv}
