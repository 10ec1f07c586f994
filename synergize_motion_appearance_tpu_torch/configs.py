"""Network configs of the port, as dicts (no YAML reader needed).

``FLAGSHIP_256`` is the released 256x256 model (options/test.yml and
``__graft_entry__._flagship_config``); ``TINY`` is options/tiny.yml, the
same code paths at img_size 64 with ~100x smaller nets. ``FLAGSHIP_TRAIN``
(options/train.yml) and ``TINY_TRAIN`` (options/tiny_train.yml) add the
discriminator and the ``train`` block that ``training.Trainer`` reads.
``FLAGSHIP_VQGAN_SR`` is VQGAN stage-1 training through
``model_api.SRModel``: a ``VQAutoEncoder`` at the flagship generator's
widths.
Keys that hold one value in every config, or act only on a TPU, are left
out; ``models.build_network`` accepts and checks them, so the JAX
package's network configs load as they are.
"""
from __future__ import annotations

import copy

FLAGSHIP_256 = {
    "network_g": dict(
        type="AppMotionCompFormer", img_size=256, nf=64,
        ch_mult=[1, 2, 2, 4], attn_resolutions=[32],
        codebook_size_motion=1024, embed_dim_motion=32,
        codebook_size_app=1024, embed_dim_app=256, n_head=8,
        dim_embd_motion=32, n_layers_motion=2, dim_embd_app=256,
        n_layers_app=2, num_kp=15,
        connect_list=["64", "128", "256"],
        connect_app_list=["32", "64", "128", "256"],
    ),
    "network_motion_estimator": dict(
        type="Motion_Estimator_keypoint_aware",
        common_params=dict(num_kp=15, num_channels=3),
        dense_motion_params=dict(
            block_expansion=64, max_features=1024, num_blocks=5,
            scale_factor=0.25,
        ),
        kp_detector_params=dict(
            temperature=0.1, block_expansion=32, max_features=1024,
            scale_factor=0.25, num_blocks=5,
        ),
    ),
}

TINY = {
    "network_g": dict(
        type="AppMotionCompFormer", img_size=64,
        nf=8, ch_mult=[1, 2, 2, 4], attn_resolutions=[8], num_kp=5,
        n_head=4,
        codebook_size_motion=64, embed_dim_motion=8, dim_embd_motion=8,
        n_layers_motion=1, codebook_size_app=64, embed_dim_app=32,
        dim_embd_app=32, n_layers_app=1,
    ),
    "network_motion_estimator": dict(
        type="Motion_Estimator_keypoint_aware",
        common_params=dict(num_kp=5, num_channels=3),
        dense_motion_params=dict(
            block_expansion=8, max_features=32, num_blocks=2,
            scale_factor=0.25,
        ),
        kp_detector_params=dict(
            temperature=0.1, block_expansion=8, max_features=32,
            scale_factor=0.25, num_blocks=2,
        ),
    ),
}



def _train_block(perceptual_scales, net_d_start_iter, **extra):
    """The ``train:`` block shared by options/train.yml and
    options/tiny_train.yml."""
    adam = dict(type="Adam", lr=8e-5, weight_decay=0, betas=[0.9, 0.99])
    return dict(
        optim_g=dict(adam), optim_motion=dict(adam), optim_d=dict(adam),
        scheduler=dict(type="MultiStepLR", milestones=[200000, 225000],
                       gamma=0.5),
        ema_decay=0.995,
        pixel_opt=dict(type="L1Loss", loss_weight=1.0, reduction="mean"),
        perceptual_opt=dict(type="MultiScalePyramidPerceptualLoss",
                            scales=perceptual_scales, num_channels=3,
                            loss_weights=[1.0] * 5),
        lr_pixel_perceptual_opt=dict(loss_weight=[0.5]),
        gan_opt=dict(type="GANLoss", gan_type="hinge", loss_weight=1.0),
        motion_codebook_code_opt=dict(loss_weight=1.0),
        motion_codebook_recon_opt=dict(type="L1Loss", loss_weight=32.0,
                                       reduction="mean"),
        app_codebook_code_opt=dict(loss_weight=1.0),
        equivariance_opt=dict(
            type="EquivarianceLoss", use_value=True, use_jacobian=True,
            loss_weight_value=1.0, loss_weight_jacobian=1.0,
            transform_params=dict(sigma_affine=0.05, sigma_tps=0.005,
                                  points_tps=5)),
        kp_distance_opt=dict(type="KPDistanceLoss", loss_weight=1.0),
        use_adaptive_weight=True, net_g_start_iter=0,
        net_d_start_iter=net_d_start_iter, scale_adaptive_gan_weight=0.8,
        **extra)


# options/train.yml: batch 2, bf16 compute with f32 master weights, no
# rematerialization, the discriminator from step 5002
FLAGSHIP_TRAIN = {
    **copy.deepcopy(FLAGSHIP_256),
    "network_d": dict(type="VQGANDiscriminator", nc=3, ndf=64, n_layers=4),
    "train": _train_block([1, 0.5, 0.25, 0.125], 5001, total_iter=250000,
                          compute_dtype="bfloat16", remat=False),
}
FLAGSHIP_TRAIN["datasets"] = {"train": dict(gt_size=256,
                                            batch_size_per_gpu=2)}

# VQGAN stage-1 training (the codebook the reenactment model builds on):
# SRModel over a VQAutoEncoder with FLAGSHIP_256's encoder, codebook and
# decoder widths (nf 64, ch_mult [1, 2, 2, 4], 2 res blocks, 1024 x 256
# codebook; attention at 16, the JAX VQAutoEncoder's default), the L1
# pixel loss, options/train.yml's Adam (lr 8e-5) and EMA (0.995); float32,
# batch 2 of 256x256
FLAGSHIP_VQGAN_SR = {
    "model_type": "SRModel",
    "is_train": True,
    "manual_seed": 0,
    "network_g": dict(type="VQAutoEncoder", img_size=256, nf=64,
                      ch_mult=[1, 2, 2, 4], res_blocks=2,
                      attn_resolutions=[16], codebook_size=1024,
                      emb_dim=256),
    "train": dict(
        optim_g=dict(type="Adam", lr=8e-5, weight_decay=0,
                     betas=[0.9, 0.99]),
        ema_decay=0.995,
        pixel_opt=dict(type="L1Loss", loss_weight=1.0, reduction="mean"),
    ),
    "val": {"metrics": {"psnr": {"type": "calculate_psnr",
                                 "crop_border": 0}}},
    "datasets": {"train": dict(gt_size=256, batch_size_per_gpu=2)},
}

# options/tiny_train.yml: float32, the discriminator from step 3
TINY_TRAIN = {
    **copy.deepcopy(TINY),
    "network_d": dict(type="VQGANDiscriminator", nc=3, ndf=8, n_layers=2),
    "train": _train_block([1, 0.5], 2, total_iter=6),
}
TINY_TRAIN["datasets"] = {"train": dict(gt_size=64, batch_size_per_gpu=2)}


def get(name: str):
    """A deep copy of the named config ('flagship_256', 'tiny',
    'flagship_train', 'flagship_vqgan_sr' or 'tiny_train')."""
    return copy.deepcopy({"flagship_256": FLAGSHIP_256, "tiny": TINY,
                          "flagship_train": FLAGSHIP_TRAIN,
                          "flagship_vqgan_sr": FLAGSHIP_VQGAN_SR,
                          "tiny_train": TINY_TRAIN}[name])
