"""AppMotionCompFormer, the generator (net_g), NCHW.

Counterpart of the JAX package's models/appmotion_former.py (reference
archs/appmotioncodebook_arch.py:170-764). At each of the four decoder
scales a motion-codebook pass refines the flow and occlusion (MRFA head)
and an appearance-codebook pass inpaints the warped source features by
cross-attention, with nested codebook prefixes per scale. Feature maps are
NCHW; flows are (B, H, W, 2) in [-1, 1] and stay float32 whatever the
compute dtype. Module names are the reference's torch names.

The JAX module's switches (the paper's ablations) are constructor
arguments with the same names and defaults: ``with_position_emb``,
``warp_s_d_kp_query`` (the motion query from the warped source and the
driving keypoints), ``MRFA_motion_enc`` (the flow/occlusion residual
head; without it the motion readout ``to_motion`` gives the flow residual
and no occlusion residual), ``motion_codebook_split`` /
``app_codebook_split`` (a codebook chunk per scale, nested prefixes, or
with ``wo_motion_cdbk_share`` / ``wo_app_cdbk_share`` disjoint chunks),
``multiscale_sft`` and ``multiscale_feature_fusion`` (the two fusions of
each connected scale). A multi-mask occlusion list from the dense motion
is read positionally, one map per scale. ``quantizer_type`` and
``detach_motion_query`` are taken and unused, as in the JAX package.

The training forward (``inference=False``) adds what the trainer reads:
the motion-codebook reconstructions and commit losses, the appearance
commit losses on the driving frame (``gt``), the parallel low-res decode
``out_lr`` and ``pre_final``, the activation entering the final RGB conv.
Its decoder region, from the first ``Upsample`` of the generator sweep to
the final RGB conv (both streams and the fusion blocks inside it, as the
JAX package's ``wl_layout`` region off the TPU), runs every 3x3 conv on
kernel K3 (``layers.decoder_region``).

Telemetry (JAX appmotion_former.py:816-933). Every forward returns
``app_before_comp_list`` (the warped, occluded features entering each
appearance compensation: the token-scale feature, then each connected
scale up to ``max(connect_app_list)``) and ``app_comp_list`` (the same
features after it), which the forward computes anyway. The two lists
that cost extra work, ``deform_feat_list`` (each scale's warp redone on
detached features and occlusion) and ``app_recon_list`` (the driving
frame's (quantized, unquantized) untokened features per appearance
scale), come only with ``telemetry=True``: the JAX trainer never reads
them and XLA drops them as dead code, where eager PyTorch would compute
them on every step. With the keyword the training forward returns them
as the JAX one does (``app_recon_list`` with ``gt``), and the inference
forward an empty ``deform_feat_list``.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import (
    grid_sample,
    interpolate_flow,
    make_coordinate_grid,
    resize_bilinear,
    resize_bilinear_at,
    resize_tap_plan,
    tap_reduce,
)
from .layers import (Conv2d, GroupNorm32, PatchEmbed, PatchUnembed,
                     decoder_region)
from .transformer import TransformerLayer
from .vqgan import (
    Downsample,
    Encoder,
    Generator,
    Upsample,
    VQGANResBlock,
    VectorQuantizer,
    encoder_block_defs,
    generator_block_defs,
)


def deform_input(inp, deformation):
    """Warp NCHW ``inp`` by a (B, Hd, Wd, 2) deformation resized to the
    input's size (bilinear, align_corners=True), then
    grid_sample(align_corners=True) (appmotioncodebook_arch.py:349-356)."""
    flow = interpolate_flow(deformation, tuple(inp.shape[2:]))
    return grid_sample(inp, flow, align_corners=True, padding_mode="zeros")


def deform_input_resized(inp, deformation, out_size, point_fn=None):
    """Equal to ``resize_bilinear(point_fn(deform_input(inp, deformation)),
    (out_size, out_size))`` for a pointwise ``point_fn``, but warps only
    at the 2*out_size tap rows and columns the downsample reads."""
    _, _, H, W = inp.shape
    ty, wy = resize_tap_plan(H, out_size)
    tx, wx = resize_tap_plan(W, out_size)
    flow = resize_bilinear_at(deformation.permute(0, 3, 1, 2), (H, W),
                              ty, tx).permute(0, 2, 3, 1)
    warped = grid_sample(inp, flow, align_corners=True,
                         padding_mode="zeros")
    if point_fn is not None:
        warped = point_fn(warped)
    return tap_reduce(warped, wy, wx)


def occlude_input(inp, occlusion_map):
    """Resize the (B, 1, h, w) occlusion to the input's size (bilinear,
    align_corners=True) and multiply, in the feature dtype."""
    if inp.shape[2:] != occlusion_map.shape[2:]:
        occlusion_map = resize_bilinear(occlusion_map, tuple(inp.shape[2:]),
                                        align_corners=True)
    return inp * occlusion_map.to(inp.dtype)


def _promoted(module, dtype, *args, **kwargs):
    """``module(*args, **kwargs)`` with its floating parameters in
    ``dtype`` where they are narrower: the JAX graph's type promotion of a
    float32 input against bfloat16 weights (the products of the rounded
    weights, in float32)."""
    weights = {k: p.to(dtype) for k, p in module.named_parameters()
               if p.dtype != dtype}
    if not weights:
        return module(*args, **kwargs)
    return torch.func.functional_call(module, weights, args, kwargs,
                                      strict=False)


def encoder_tap_indices(nf, emb_dim, ch_mult, res_blocks, resolution,
                        attn_resolutions):
    """resolution -> encoder block index of its skip feature
    ({256: 2, 128: 5, 64: 8, 32: 11} for the flagship config)."""
    defs = encoder_block_defs(nf, emb_dim, ch_mult, res_blocks, resolution,
                              attn_resolutions)
    taps = {}
    curr = resolution
    lowest = resolution // 2 ** (len(ch_mult) - 1)
    group_count = 0
    for i, (kind, _) in enumerate(defs):
        if kind == "down":
            taps[curr] = i - 1
            curr //= 2
            group_count = 0
        elif curr == lowest and kind in ("res", "attn"):
            group_count += 1
            per_group = 2 if lowest in attn_resolutions else 1
            if group_count == per_group and lowest not in taps:
                taps[lowest] = i
    return taps


def generator_tap_indices(nf, emb_dim, ch_mult, res_blocks, resolution,
                          attn_resolutions):
    """resolution -> generator block index after which that scale fuses
    ({32: 6, 64: 9, 128: 12, 256: 15} for the flagship config)."""
    defs = generator_block_defs(nf, emb_dim, ch_mult, res_blocks, resolution,
                                attn_resolutions)
    taps = {}
    lowest = resolution // 2 ** (len(ch_mult) - 1)
    curr = lowest
    res_seen_at_lowest = 0
    after_up = False
    for i, (kind, _) in enumerate(defs):
        if i < 4:
            continue
        if kind == "res" and curr == lowest and lowest not in taps:
            res_seen_at_lowest += 1
            if res_seen_at_lowest == res_blocks:
                taps[lowest] = i
        if kind == "up":
            curr *= 2
            after_up = True
        elif after_up and kind == "res":
            if curr not in taps:
                taps[curr] = i
            after_up = False
    return taps


class FuseSftBlock(nn.Module):
    """CFT scale/shift fusion (appmotioncodebook_arch.py:28-52)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.encode_enc = VQGANResBlock(2 * in_ch, out_ch)
        self.scale = nn.Sequential(
            Conv2d(out_ch, out_ch, 3, padding=1), nn.LeakyReLU(0.2),
            Conv2d(out_ch, out_ch, 3, padding=1))
        self.shift = nn.Sequential(
            Conv2d(out_ch, out_ch, 3, padding=1), nn.LeakyReLU(0.2),
            Conv2d(out_ch, out_ch, 3, padding=1))

    def forward(self, enc_feat, dec_feat, w=1.0):
        enc = self.encode_enc(torch.cat([enc_feat, dec_feat], dim=1))
        return dec_feat + w * (dec_feat * self.scale(enc) + self.shift(enc))


class BasicMotionEncoder(nn.Module):
    """MRFA motion encoder (appmotioncodebook_arch.py:129-147)."""

    def __init__(self, motion_dim: int):
        super().__init__()
        self.convc1 = nn.Conv2d(motion_dim, 128, 1)
        self.convc2 = nn.Conv2d(128, 96, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(96 + 64, 126, 3, padding=1)

    def forward(self, delta_flow, motion_feat):
        cor = F.relu(self.convc2(F.relu(self.convc1(motion_feat))))
        flo = F.relu(self.convf2(F.relu(self.convf1(delta_flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, delta_flow], dim=1)  # 128 channels


class RefineFlow(nn.Module):
    """MRFA flow/occlusion residual head (appmotioncodebook_arch.py:150-167)."""

    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(192, 128, 3, padding=1)
        self.conv1 = nn.Conv2d(256, 128, 3, padding=1)
        self.conv2 = nn.Conv2d(128, 2, 3, padding=1)
        self.convo1 = nn.Conv2d(256, 128, 3, padding=1)
        self.convo2 = nn.Conv2d(128, 1, 3, padding=1)

    def forward(self, m_f, warp_f):
        inp = torch.cat([m_f, F.relu(self.convc1(warp_f))], dim=1)
        flow = self.conv2(F.relu(self.conv1(inp)))
        occ = self.convo2(F.relu(self.convo1(inp)))
        return torch.cat([flow, occ], dim=1)  # (B, 3, Hd, Wd)


class AppMotionCompFormer(nn.Module):
    def __init__(self, img_size: int = 256, nf: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 2, 4), res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (32,), beta: float = 0.25,
                 codebook_size_motion: int = 1024, embed_dim_motion: int = 32,
                 codebook_size_app: int = 1024, embed_dim_app: int = 256,
                 n_head: int = 8, dim_embd_motion: int = 32,
                 n_layers_motion: int = 2, dim_embd_app: int = 256,
                 n_layers_app: int = 2, num_kp: int = 15,
                 quantizer_type: str = "nearest",
                 with_position_emb: bool = True,
                 warp_s_d_kp_query: bool = True,
                 MRFA_motion_enc: bool = True,
                 motion_codebook_split: bool = True,
                 detach_motion_query: bool = True,
                 multiscale_feature_fusion: bool = True,
                 multiscale_sft: bool = True,
                 app_codebook_split: bool = True,
                 wo_motion_cdbk_share: bool = False,
                 wo_app_cdbk_share: bool = False,
                 connect_list: Optional[Sequence[Any]] = None,
                 connect_app_list: Optional[Sequence[Any]] = None):
        """Arguments as the JAX module's fields."""
        super().__init__()
        # taken and never read, as in the JAX package: the quantizer is
        # always the nearest entry, and the motion embedding always takes
        # the detached flow (appmotion_former.py:241, 257, 515)
        del quantizer_type, detach_motion_query
        self.with_position_emb = with_position_emb
        self.warp_s_d_kp_query = warp_s_d_kp_query
        self.MRFA_motion_enc = MRFA_motion_enc
        self.motion_codebook_split = motion_codebook_split
        self.multiscale_feature_fusion = multiscale_feature_fusion
        self.multiscale_sft = multiscale_sft
        self.app_codebook_split = app_codebook_split
        self.wo_motion_cdbk_share = wo_motion_cdbk_share
        self.wo_app_cdbk_share = wo_app_cdbk_share
        ch_mult = tuple(ch_mult)
        attn_resolutions = tuple(attn_resolutions)
        self.img_size = img_size
        self.nf = nf
        self.ch_mult = ch_mult
        self.res_blocks = res_blocks
        self.attn_resolutions = attn_resolutions
        self.embed_dim_app = embed_dim_app
        self.n_layers_motion = n_layers_motion
        self.n_layers_app = n_layers_app
        self.dim_embd_motion = dim_embd_motion
        self.dim_embd_app = dim_embd_app

        n = len(ch_mult)
        self.scales: List[int] = [img_size // 2 ** (n - 1 - i)
                                  for i in range(n)]
        t = self.token_hw = self.scales[0]
        rev = list(reversed(ch_mult))
        ch = {r: nf * rev[i] for i, r in enumerate(self.scales)}
        self.connect = ([int(r) for r in connect_list]
                        if connect_list is not None else self.scales[1:])
        self.connect_app = ([int(r) for r in connect_app_list]
                            if connect_app_list is not None else self.scales)
        # channels of the feature each scale's motion/appearance pass
        # reads: the encoder latent at the token scale, skips elsewhere
        feat_ch = {r: embed_dim_app if r == t else ch[r]
                   for r in self.scales}

        self.encoder = Encoder(nf, embed_dim_app, ch_mult, res_blocks,
                               img_size, attn_resolutions)
        # the generator reads the compensated appearance features, which
        # to_app_feat_{t} gives ch[t] channels (the JAX conv takes the
        # width it is fed; ch[t] is embed_dim_app in every shipped config)
        self.generator = Generator(nf, ch[t], ch_mult, res_blocks,
                                   img_size, attn_resolutions)
        self.enc_taps = encoder_tap_indices(nf, embed_dim_app, ch_mult,
                                            res_blocks, img_size,
                                            attn_resolutions)
        self.gen_taps = generator_tap_indices(nf, embed_dim_app, ch_mult,
                                              res_blocks, img_size,
                                              attn_resolutions)

        for r in self.connect_app:
            p = r // t
            if p == 1:
                emb = nn.Conv2d(feat_ch[r], dim_embd_app, 1)
                unemb = nn.Conv2d(dim_embd_app, ch[r], 1)
            else:
                emb = PatchEmbed(p, feat_ch[r], dim_embd_app)
                unemb = PatchUnembed(p, dim_embd_app, ch[r])
            self.add_module(f"app_feat_emb_{r}", emb)
            self.add_module(f"to_app_feat_{r}", unemb)

        self.quantize_app = VectorQuantizer(codebook_size_app, embed_dim_app,
                                            beta)
        self.quantize_motion = VectorQuantizer(codebook_size_motion,
                                               embed_dim_motion, beta)
        if multiscale_sft:
            self.fuse_convs_dict = nn.ModuleDict(
                {str(r): FuseSftBlock(ch[r], ch[r]) for r in self.connect})
        if multiscale_feature_fusion:
            self.fuse_ms_dict = nn.ModuleDict(
                {str(r): Conv2d(ch[r], ch[r], 3, padding=1)
                 for r in self.connect})
        if with_position_emb:
            self.position_emb_app = nn.Parameter(
                torch.zeros(t * t, dim_embd_app))
            self.position_emb_motion = nn.Parameter(
                torch.zeros(t * t, dim_embd_motion))

        dm = dim_embd_motion
        self.motion_emb = nn.Sequential(
            nn.Conv2d(2, dm, 3, padding=1), Downsample(dm),
            VQGANResBlock(dm, dm))
        # the reconstruction head of the training losses
        self.to_motion = nn.Sequential(
            Upsample(dm), VQGANResBlock(dm, dm), GroupNorm32(dm),
            nn.Conv2d(dm, 2, 3, padding=1))
        self.motion_block = nn.ModuleList(
            [TransformerLayer(dm, n_head, dm * 2)
             for _ in range(n_layers_motion)])
        self.app_block = nn.ModuleList(
            [TransformerLayer(dim_embd_app, n_head, dim_embd_app * 2)
             for _ in range(n_layers_app)])

        if MRFA_motion_enc:
            self.BasicMotionEncoder = BasicMotionEncoder(dm)
            self.to_context = nn.ModuleList(
                [nn.Conv2d(feat_ch[r], 192, 1) for r in self.scales])
            self.refine = RefineFlow()
        if warp_s_d_kp_query:
            for r in self.scales:
                self.add_module(f"warped_source_enc_{r}",
                                nn.Conv2d(feat_ch[r], dm, 1))
            self.driving_kp_enc = nn.Conv2d(num_kp, dm, 1)
            self.motion_query_enc_1 = nn.Conv2d(2 * dm, dm, 1)
            self.motion_query_enc_2 = nn.Conv2d(2 * dm, dm, 1)

    # ---------------- helpers ----------------

    @property
    def compute_dtype(self):
        return self.motion_emb[0].weight.dtype

    def _codebook_range(self, quantizer, split_count, res, split, disjoint):
        """(start, num) of the codebook rows that scale ``res`` reads
        (appmotioncodebook_arch.py:400-407, 508-525): the whole book
        without ``split``; else the scale's chunk of ``split_count``
        (``disjoint``) or every chunk up to it (nested prefixes)."""
        if not split:
            return 0, quantizer.codebook_size
        chunk = quantizer.codebook_size // split_count
        idx = self.scales.index(res) + 1
        return (chunk * (idx - 1), chunk) if disjoint else (0, chunk * idx)

    def motion_codebook_compensation(self, motion, query_feat, res,
                                     warp_ctx, train: bool = False):
        """appmotioncodebook_arch.py:373-427.

        motion: (B, Hd, Wd, 2) flow residual in pixels; query_feat:
        (B, dim, t, t), or None without ``warp_s_d_kp_query`` (the motion
        embedding is then the query); warp_ctx: relu(to_context(warped
        source)) at (Hd, Wd), or None without ``MRFA_motion_enc``. Returns
        the (B, 3, Hd, Wd) flow residual and occlusion logit (MRFA), or
        the (B, 2, 2t, 2t) flow residual of ``to_motion``, and with
        ``train`` the (B, Hd, Wd, 2) reconstruction of the motion from its
        quantized embedding and the commit loss (else None, None)."""
        B, Hd, Wd, _ = motion.shape
        t = self.token_hw
        dim = self.dim_embd_motion
        m = motion.permute(0, 3, 1, 2)
        # The flow residual is float32 (it is taken against the float32
        # coordinate grid), and the JAX graph's type promotion runs every
        # module it reaches in float32 on weights in the compute dtype:
        # the motion embedding, the motion transformer, the motion
        # encoder and the flow/occlusion head. So does this pass.
        dt = torch.promote_types(m.dtype, self.compute_dtype)

        def run(module, *args, **kwargs):
            return _promoted(module, dt, *args, **kwargs)

        m_feat = run(self.motion_emb, m.detach())             # (B, dim, t, t)
        if query_feat is None:
            query_emb = m_feat
        else:
            if query_feat.shape[2:] != m_feat.shape[2:]:
                query_feat = resize_bilinear(
                    query_feat, tuple(m_feat.shape[2:]), align_corners=True)
            query_emb = run(self.motion_query_enc_2,
                            torch.cat([m_feat, query_feat.to(dt)], dim=1))
        tokens = query_emb.flatten(2).transpose(1, 2)         # (B, t*t, dim)
        pos = self.position_emb_motion[None] if self.with_position_emb \
            else None
        start, num = self._codebook_range(
            self.quantize_motion, 1 + len(self.connect), res,
            self.motion_codebook_split, self.wo_motion_cdbk_share)
        context = self.quantize_motion.codebook_slice(start, num)
        for block in self.motion_block:
            tokens = run(block, tokens, context.to(dt), (t, t),
                         query_pos=pos)
        query_emb = tokens.transpose(1, 2).reshape(B, dim, t, t)
        if self.MRFA_motion_enc:
            motion_f = resize_bilinear(query_emb, (Hd, Wd),
                                       align_corners=True)
            m_f = run(self.BasicMotionEncoder, m.to(dt), motion_f)
            m_res = run(self.refine, m_f, warp_ctx.to(dt))
        else:
            m_res = run(self.to_motion, query_emb)
        if not train:
            return m_res, None, None
        z_q, loss, _ = self.quantize_motion(m_feat.permute(0, 2, 3, 1),
                                            start=start, num=num)
        m_recon = run(self.to_motion, z_q.permute(0, 3, 1, 2))
        return m_res, m_recon.permute(0, 2, 3, 1), loss

    def _app_tokens(self, feat, res):
        """(B, C, r, r) -> (B, t*t, dim_embd_app) patch embedding."""
        emb = getattr(self, f"app_feat_emb_{res}")
        if res == self.token_hw:
            return emb(feat).flatten(2).transpose(1, 2)
        return emb(feat)

    def _app_untokens(self, tokens, res):
        """Inverse of _app_tokens: (B, t*t, d) -> (B, C, r, r)."""
        unemb = getattr(self, f"to_app_feat_{res}")
        if res == self.token_hw:
            B, L, D = tokens.shape
            t = self.token_hw
            return unemb(tokens.transpose(1, 2).reshape(B, D, t, t))
        return unemb(tokens)

    def app_codebook_compensation(self, feat, motion):
        """appmotioncodebook_arch.py:472-544: the first block ignores
        tokens whose flow points outside the image."""
        B = feat.shape[0]
        r = feat.shape[2]
        t = self.token_hw
        m = resize_bilinear(motion.permute(0, 3, 1, 2), (t, t),
                            align_corners=True)               # (B, 2, t, t)
        ignore = ((m > 1) | (m < -1)).any(dim=1).reshape(B, t * t)
        tokens = self._app_tokens(feat, r)
        pos = self.position_emb_app[None] if self.with_position_emb else None
        context = self.quantize_app.codebook_slice(*self._codebook_range(
            self.quantize_app, len(self.connect_app), r,
            self.app_codebook_split, self.wo_app_cdbk_share))
        for j, block in enumerate(self.app_block):
            tokens = block(tokens, context, (t, t),
                           key_padding_mask=ignore if j == 0 else None,
                           query_pos=pos)
        return self._app_untokens(tokens, r)

    def app_codebook_loss(self, gt, recon: bool = False):
        """Commit losses of the driving frame's encoder features against
        the appearance codebook rows of each scale
        (appmotioncodebook_arch.py:429-469), and with ``recon`` each
        scale's (quantized, unquantized) tokens untokened back to its
        feature map (else an empty list): (recon_list, loss_list)."""
        taps = {self.enc_taps[r]: r for r in self.connect_app}
        _, feats = self.encoder(gt, taps=taps)
        t = self.token_hw
        recons, losses = [], []
        for r in self.connect_app:
            tokens = self._app_tokens(feats[self.enc_taps[r]], r)
            grid = tokens.reshape(-1, t, t, self.dim_embd_app)
            start, num = self._codebook_range(
                self.quantize_app, len(self.connect_app), r,
                self.app_codebook_split, self.wo_app_cdbk_share)
            quant, loss, _ = self.quantize_app(grid, start=start, num=num)
            losses.append(loss)
            if recon:
                recons.append((
                    self._app_untokens(quant.reshape(tokens.shape), r),
                    self._app_untokens(tokens, r)))
        return recons, losses

    def encode_source(self, x):
        """One encoder sweep -> {'latent', 'feats'}; pass it as
        ``source_feats`` so a source is encoded once, not per frame batch.
        A batch-1 result is read by every frame of a batch."""
        enc_tap_idx = {self.enc_taps[r]: r for r in self.connect}
        latent, taps = self.encoder(x, taps=enc_tap_idx)
        return {"latent": latent,
                "feats": {enc_tap_idx[i]: f for i, f in taps.items()}}

    # ---------------- forward ----------------

    def forward(self, x, dense_motion, w: float = 1.0,
                inference: bool = False, gt=None, source_feats=None,
                telemetry: bool = False):
        """x: (1 or B, 3, H, W) source in [-1, 1]; dense_motion from the
        MotionEstimator; gt: (B, 3, H, W) driving frame, whose appearance
        commit losses the training forward adds. Returns a dict whose 'out'
        is the (B, 3, H, W) generated frame; ``inference=False`` adds the
        training outputs and ``telemetry=True`` the two costly telemetry
        lists (see the module docstring)."""
        if x.shape[2] != self.img_size or x.shape[3] != self.img_size:
            raise ValueError(
                f"AppMotionCompFormer(img_size={self.img_size}) got source "
                f"of shape {tuple(x.shape)}; resize inputs to "
                f"({self.img_size}, {self.img_size}) first.")
        train = not inference
        if source_feats is None:
            source_feats = self.encode_source(x)
        enc_feat_dict = source_feats["feats"]
        x = source_feats["latent"]
        t = self.token_hw
        dt = self.compute_dtype

        deformation = dense_motion["deformation"]          # (B, Hd, Wd, 2)
        Hd, Wd = deformation.shape[1:3]
        half = (Hd - 1.0) / 2.0
        grid = make_coordinate_grid(Hd, Wd, device=deformation.device)[None]
        motion_list = [deformation]
        res_motion_list = []
        out_occ = []
        motion_recon_list = []
        codebook_loss_motion_list = []
        if "occlusion_map" not in dense_motion:
            # the JAX generator reads the key unconditionally and fails
            raise KeyError("AppMotionCompFormer needs the dense motion's "
                           "'occlusion_map': build the motion estimator with "
                           "estimate_occlusion_map=True")
        # (B, 1, Hd, Wd), or with multi_mask a coarse-to-fine list of
        # maps, one per scale in order, whose MRFA occlusion residuals are
        # computed and not applied (:598, 606-610, 702-706)
        dense_occ = dense_motion["occlusion_map"]
        occ_maps = (list(dense_occ) if isinstance(dense_occ, (list, tuple))
                    else None)

        def occlusion(d_occ):
            """The occlusion map of the current scale."""
            if occ_maps is not None:
                return occ_maps.pop(0)
            if not self.MRFA_motion_enc:
                return dense_occ
            out_occ.append(torch.sigmoid(
                (out_occ[-1] if out_occ else dense_occ) + d_occ))
            return out_occ[-1]

        driving_kp_feat = None
        if self.warp_s_d_kp_query:
            kp_heat = resize_bilinear(dense_motion["driving_kp_heatmap"],
                                      (t, t), align_corners=True)
            driving_kp_feat = F.relu(self.driving_kp_enc(kp_heat.to(dt)))

        def motion_pass(feat, res):
            """One motion-codebook pass at feature resolution ``res``;
            returns the MRFA occlusion logit, or None. Where the query or
            the MRFA context reads the warped feature above twice its
            size, the full-resolution warp is replaced by warps at the
            downsample taps (deform_input_resized), as in JAX. With
            neither switch the JAX pass warps the feature and reads
            nothing of it; here it is not warped."""
            motion_q = motion_list[-1]
            H = feat.shape[2]
            dense = ((self.warp_s_d_kp_query and 2 * t >= H)
                     or (self.MRFA_motion_enc and 2 * Hd >= H))
            warp_src = deform_input(feat, motion_q) if dense else None
            q_feat = warp_ctx = None
            if self.warp_s_d_kp_query:
                if warp_src is not None:
                    ws = resize_bilinear(warp_src, (t, t),
                                         align_corners=True)
                else:
                    ws = deform_input_resized(feat, motion_q, t)
                ws = F.relu(getattr(self, f"warped_source_enc_{res}")(ws))
                q_feat = self.motion_query_enc_1(
                    torch.cat([ws, driving_kp_feat], dim=1))
            if self.MRFA_motion_enc:
                to_context = self.to_context[self.scales.index(res)]

                def ctx_fn(v):
                    return F.relu(to_context(v))

                if warp_src is not None:
                    warp_ctx = resize_bilinear(ctx_fn(warp_src), (Hd, Wd),
                                               align_corners=True)
                else:
                    warp_ctx = deform_input_resized(feat, motion_q, Hd,
                                                    point_fn=ctx_fn)
            m_res, m_recon, cb_loss = self.motion_codebook_compensation(
                (motion_q - grid) * half, q_feat, res, warp_ctx, train)
            res_motion_list.append(m_res[:, 0:2].permute(0, 2, 3, 1) / half)
            motion_list.append(motion_q + res_motion_list[-1])
            if train:
                motion_recon_list.append(m_recon / half)
                codebook_loss_motion_list.append(cb_loss)
            return m_res[:, 2:3] if self.MRFA_motion_enc else None

        def detached_warp(feat, occ):
            """deform_feat_list's entry: the warp redone on the detached
            feature and occlusion (the flow keeps its gradient)."""
            return occlude_input(deform_input(feat.detach(), motion_list[-1]),
                                 occ.detach())

        deform_feat_list = []
        # base scale (the token grid)
        occ = occlusion(motion_pass(x, self.scales[0]))
        m_com = motion_list[-1]
        lq_feat = occlude_input(deform_input(x, m_com), occ)
        if telemetry and train:
            deform_feat_list.append(detached_warp(x, occ))
        app_before_comp_list = [lq_feat]
        lq_feat = self.app_codebook_compensation(lq_feat, m_com)
        app_comp_list = [lq_feat]
        app_recon_list, codebook_loss_app_list = (
            self.app_codebook_loss(gt, recon=telemetry)
            if train and gt is not None else ([], None))

        # generator sweep with per-scale fusion; in training also the
        # parallel low-res decode of lq_feat through the same blocks
        xg = lq_feat
        x_lr = lq_feat if train else None
        gen_tap_idx = {self.gen_taps[r]: r for r in self.connect}
        max_app_res = max(self.connect_app)
        last = len(self.generator.blocks) - 1
        region = False
        pre_final = None
        for i, block in enumerate(self.generator.blocks):
            if train and isinstance(block, Upsample):
                region = True
            if i == last:
                region = False
                pre_final = xg
            with decoder_region(region):
                xg = block(xg)
                if x_lr is not None:
                    x_lr = block(x_lr)
            if i not in gen_tap_idx:
                continue
            f_res = gen_tap_idx[i]
            enc_feat = enc_feat_dict[f_res]
            occ = occlusion(motion_pass(enc_feat, f_res))
            m_com = motion_list[-1]
            enc_feat_warped = occlude_input(deform_input(enc_feat, m_com),
                                            occ)
            if telemetry and train:
                deform_feat_list.append(detached_warp(enc_feat, occ))
            if f_res <= max_app_res:
                app_before_comp_list.append(enc_feat_warped)
                enc_feat_warped = self.app_codebook_compensation(
                    enc_feat_warped, m_com)
                app_comp_list.append(enc_feat_warped)
            with decoder_region(region):
                if self.multiscale_sft:
                    xg = self.fuse_convs_dict[str(f_res)](enc_feat_warped,
                                                          xg, w)
                if self.multiscale_feature_fusion:
                    xg = xg + self.fuse_ms_dict[str(f_res)](enc_feat_warped)

        out = {
            "out": xg,
            "lq_feat": lq_feat,
            "out_occ": out_occ,
            "deformation_list": motion_list,
            "res_deform_list": res_motion_list,
            "app_comp_list": app_comp_list,
            "app_before_comp_list": app_before_comp_list,
        }
        if telemetry:
            out["deform_feat_list"] = deform_feat_list
        if train:
            out.update(pre_final=pre_final, out_lr=[x_lr],
                       motion_recon_list=motion_recon_list,
                       codebook_loss_motion_list=codebook_loss_motion_list)
            if codebook_loss_app_list is not None:
                out["codebook_loss_app_list"] = codebook_loss_app_list
                if telemetry:
                    out["app_recon_list"] = app_recon_list
        return out
