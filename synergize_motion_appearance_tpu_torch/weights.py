"""Weights of the port: seeded random weights, and the bridge from the
JAX package's parameter trees to the port's state_dicts.

No trained weights ship with the repository; ``seeded_nets`` builds the
two networks of a config with weights made from a seed, and
``seeded_train_nets`` the four networks of a training config.

The JAX package keeps each network's variables as ``{"params": ...,
"batch_stats": ...}`` trees; given as nested dicts of numpy arrays, these
functions return the reference-named torch state_dicts that the port's
modules load with ``strict=True``. The name map is this package's own copy
of the reverse direction of tools/convert_reference_checkpoint.py
(``Converter.mha``, ``map_motion_estimator``, ``map_net_g``): conv kernels
HWIO -> OIHW, linear (I, O) -> (O, I), attention wq/wk/wv -> the packed
(3E, E) ``in_proj_weight``, BatchNorm scale/bias + running stats, and the
fixed anti-alias blur buffers, which have no JAX parameter. The
discriminator's names follow ``map_net_d`` of that tool, and VGG19's are
torchvision's, the reverse of tools/convert_vgg_weights.py's
``torch_vgg_to_flax``. The VQGAN family (``VQAutoEncoder``,
``AutoEncoder``, ``AutoEncoder_MSDecoder``, and ``GumbelQuantizer`` and
``FuseFeatBlock``) and ``VGGFeatureExtractor`` map through
``network_state_dict``; ``MSGenerator``'s torch names are its JAX module
names. The blocks of ``models.arch_util`` and ``models.extended_blocks``
map through ``block_state_dict``, which walks the port module: conv
kernels HWIO -> OIHW (a 3-D conv's DHWIO -> OIDHW), a DCN's own weight
likewise, weight norm's ``v``/``g`` into ``weight_v``/``weight_g``, and
the towers' ``conv{i}`` / ``block{i}`` into ``nn.Sequential`` indices.
``load_train_state`` carries a whole JAX
``TrainState`` (weights, BatchNorm statistics, EMA, Adam moments and
counts) into a ``training.Trainer``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from .models import VGG19Features, build_network
from .models import arch_util, extended_blocks, motion_blocks
from .models.layers import BatchNorm2d
from .models.vgg import CONV_INDICES
from .models.vqgan import (AttnBlock, Upsample, VQGANResBlock,
                           encoder_block_defs, generator_block_defs)
from .ops import antialias_weight


def seeded_nets(cfg, seed: int):
    """(net_g, motion_estimator) of ``cfg`` with PyTorch's default init
    from ``seed``, and seeded non-trivial BatchNorm running statistics.
    Built on the CPU, so a seed gives the same weights on every machine."""
    torch.manual_seed(seed)
    g = build_network(cfg["network_g"])
    me = build_network(cfg["network_motion_estimator"])
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in me.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(
                    0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(
                    0.5 + torch.rand(m.running_var.shape, generator=gen))
    return g, me


def seeded_train_nets(opt, seed: int):
    """(net_g, motion_estimator, net_d, vgg) of a training config
    (``opt['network_d']`` too) with PyTorch's default init from ``seed``,
    built on the CPU. The VGG19 weights are random as well, since no
    pretrained ones are in the repository."""
    g, me = seeded_nets(opt, seed)
    torch.manual_seed(seed + 2)
    return g, me, build_network(opt["network_d"]), VGG19Features()


class _Exporter:
    def __init__(self, variables: Dict[str, Any]):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: Dict[str, np.ndarray] = {}

    @staticmethod
    def _get(tree, path):
        node = tree
        for p in path.split("/"):
            node = node[p]
        return np.asarray(node)

    def has(self, path) -> bool:
        node = self.params
        for p in path.split("/"):
            if not isinstance(node, dict) or p not in node:
                return False
            node = node[p]
        return True

    def conv(self, tkey, fpath):
        """flax conv at ``fpath`` (HWIO kernel) -> torch conv (OIHW)."""
        self.sd[tkey + ".weight"] = self._get(
            self.params, fpath + "/kernel").transpose(3, 2, 0, 1)
        if self.has(fpath + "/bias"):
            self.sd[tkey + ".bias"] = self._get(self.params, fpath + "/bias")

    def conv2d(self, tkey, fpath):
        """the JAX Conv2d wrapper nests its conv as Conv_0"""
        self.conv(tkey, fpath + "/Conv_0")

    def dense(self, tkey, fpath):
        p = fpath + "/Dense_0"
        self.sd[tkey + ".weight"] = self._get(self.params, p + "/kernel").T
        self.sd[tkey + ".bias"] = self._get(self.params, p + "/bias")

    def bn(self, tkey, fpath):
        p = fpath + "/BatchNorm_0"
        self.sd[tkey + ".weight"] = self._get(self.params, p + "/scale")
        self.sd[tkey + ".bias"] = self._get(self.params, p + "/bias")
        self.sd[tkey + ".running_mean"] = self._get(self.stats, p + "/mean")
        self.sd[tkey + ".running_var"] = self._get(self.stats, p + "/var")
        self.sd[tkey + ".num_batches_tracked"] = np.asarray(0)

    def affine(self, tkey, fpath, sub):
        p = f"{fpath}/{sub}"
        self.sd[tkey + ".weight"] = self._get(self.params, p + "/scale")
        self.sd[tkey + ".bias"] = self._get(self.params, p + "/bias")

    def gn(self, tkey, fpath):
        self.affine(tkey, fpath, "GroupNorm_0")

    def ln(self, tkey, fpath):
        self.affine(tkey, fpath, "LayerNorm_0")

    def mha(self, tkey, fpath):
        wq, wk, wv = (self._get(self.params, f"{fpath}/{n}")
                      for n in ("wq", "wk", "wv"))
        self.sd[tkey + ".in_proj_weight"] = np.concatenate(
            [wq.T, wk.T, wv.T], axis=0)
        self.sd[tkey + ".in_proj_bias"] = self._get(
            self.params, fpath + "/in_proj_bias")
        self.sd[tkey + ".out_proj.weight"] = self._get(
            self.params, fpath + "/out_proj_kernel").T
        self.sd[tkey + ".out_proj.bias"] = self._get(
            self.params, fpath + "/out_proj_bias")

    def direct(self, tkey, fpath):
        self.sd[tkey] = self._get(self.params, fpath)

    def res_block(self, t, f):
        self.gn(f"{t}.norm1", f"{f}/norm1")
        self.conv2d(f"{t}.conv1", f"{f}/conv1")
        self.gn(f"{t}.norm2", f"{f}/norm2")
        self.conv2d(f"{t}.conv2", f"{f}/conv2")
        if self.has(f"{f}/conv_out/Conv_0/kernel"):
            self.conv2d(f"{t}.conv_out", f"{f}/conv_out")

    def hourglass(self, t, f, num_blocks):
        for i in range(num_blocks):
            self.conv2d(f"{t}.encoder.down_blocks.{i}.conv",
                        f"{f}/encoder/down_{i}/conv")
            self.bn(f"{t}.encoder.down_blocks.{i}.norm",
                    f"{f}/encoder/down_{i}/norm")
            self.conv2d(f"{t}.decoder.up_blocks.{i}.conv",
                        f"{f}/decoder/up_{i}/conv")
            self.bn(f"{t}.decoder.up_blocks.{i}.norm",
                    f"{f}/decoder/up_{i}/norm")

    def block_list(self, defs, t_prefix, f_prefix):
        for i, (kind, _) in enumerate(defs):
            t = f"{t_prefix}.{i}"
            f = f"{f_prefix}_{i}"
            if kind == "conv":
                self.conv2d(t, f"{f}/conv")
            elif kind == "res":
                self.res_block(t, f)
            elif kind == "attn":
                self.attn(t, f)
            elif kind in ("down", "up"):
                self.conv2d(f"{t}.conv", f"{f}/conv")
            elif kind == "norm":
                self.gn(t, f"{f}/norm")

    def attn(self, t, f):
        self.gn(f"{t}.norm", f"{f}/norm")
        for name in ("q", "k", "v", "proj_out"):
            self.conv2d(f"{t}.{name}", f"{f}/{name}")

    def modules_by_kind(self, module, t_prefix, f_prefix):
        """Each child of a port module whose attribute names are the JAX
        module names (``MSGenerator``), mapped by its kind."""
        for name, m in module.named_children():
            t, f = f"{t_prefix}.{name}", f"{f_prefix}/{name}"
            if isinstance(m, VQGANResBlock):
                self.res_block(t, f)
            elif isinstance(m, AttnBlock):
                self.attn(t, f)
            elif isinstance(m, Upsample):
                self.conv2d(f"{t}.conv", f"{f}/conv")
            elif isinstance(m, torch.nn.GroupNorm):
                self.gn(t, f)
            else:
                self.conv2d(t, f)

    def transformer_layer(self, t, f):
        self.mha(f"{t}.self_attn", f"{f}/self_attn")
        self.mha(f"{t}.cross_attn", f"{f}/cross_attn")
        self.conv2d(f"{t}.conv1", f"{f}/conv1")
        self.conv2d(f"{t}.conv2", f"{f}/conv2")
        for n in ("norm1", "norm2", "norm3"):
            self.ln(f"{t}.{n}", f"{f}/{n}")

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in self.sd.items()}


def motion_estimator_state_dict(variables, me_cfg) -> Dict[str, torch.Tensor]:
    """MotionEstimator variables -> the port's (reference-named)
    state_dict. ``me_cfg`` is the network_motion_estimator config; its
    switches decide which heads exist: the Jacobian conv
    (``estimate_jacobian``), and the occlusion head
    (``estimate_occlusion_map``), which with ``multi_mask`` is the list
    ``occlusion.{i}`` and the UpBlock2d chain ``up.{i}``."""
    common = dict(me_cfg.get("common_params", {}))
    kp_cfg = {**common, **me_cfg["kp_detector_params"]}
    dm_cfg = {**common, **me_cfg["dense_motion_params"]}
    channels = common.get("num_channels", 3)
    e = _Exporter(variables)
    e.hourglass("kp_detector.predictor", "kp_detector/predictor",
                kp_cfg.get("num_blocks", 5))
    e.conv2d("kp_detector.kp", "kp_detector/kp")
    if kp_cfg.get("estimate_jacobian", True):
        e.conv("kp_detector.jacobian", "kp_detector/jacobian")  # nn.Conv
    dm = "dense_motion_network"
    e.hourglass(f"{dm}.hourglass", f"{dm}/hourglass",
                dm_cfg.get("num_blocks", 5))
    e.conv2d(f"{dm}.mask", f"{dm}/mask")
    if dm_cfg.get("estimate_occlusion_map", True):
        if dm_cfg.get("multi_mask", False):
            up_nums = int(math.log(1.0 / dm_cfg.get("scale_factor", 0.25),
                                   2))
            for i in range(dm_cfg.get("occlusion_num", 5)):
                e.conv2d(f"{dm}.occlusion.{i}", f"{dm}/occlusion_{i}")
            for i in range(up_nums):
                e.conv2d(f"{dm}.up.{i}.conv", f"{dm}/up_{i}/conv")
                e.bn(f"{dm}.up.{i}.norm", f"{dm}/up_{i}/norm")
        else:
            e.conv2d(f"{dm}.occlusion", f"{dm}/occlusion")
    sd = e.state_dict()
    for key, cfg in (("kp_detector", kp_cfg), ("dense_motion_network", dm_cfg)):
        scale = cfg.get("scale_factor", 0.25)
        if scale != 1:
            sd[f"{key}.down.weight"] = antialias_weight(channels, scale)
    return sd


def net_g_state_dict(variables, net_cfg) -> Dict[str, torch.Tensor]:
    """AppMotionCompFormer variables -> the port's (reference-named)
    state_dict. ``net_cfg`` is the network_g config."""
    with torch.device("meta"):  # structure only, no weights allocated
        net = build_network(net_cfg)
    e = _Exporter(variables)
    args = (net.nf, net.embed_dim_app, net.ch_mult, net.res_blocks,
            net.img_size, net.attn_resolutions)
    e.block_list(encoder_block_defs(*args), "encoder.blocks",
                 "encoder_blocks")
    e.block_list(generator_block_defs(*args), "generator.blocks",
                 "generator_blocks")
    for r in net.connect_app:
        if r == net.token_hw:
            e.conv2d(f"app_feat_emb_{r}", f"app_feat_emb_{r}")
            e.conv2d(f"to_app_feat_{r}", f"to_app_feat_{r}")
        else:
            e.dense(f"app_feat_emb_{r}.1", f"app_feat_emb_{r}")
            e.dense(f"to_app_feat_{r}.0", f"to_app_feat_{r}")
    e.direct("quantize_app.embedding.weight", "quantize_app/embedding")
    e.direct("quantize_motion.embedding.weight", "quantize_motion/embedding")
    if net.with_position_emb:
        e.direct("position_emb_app", "position_emb_app")
        e.direct("position_emb_motion", "position_emb_motion")
    for r in net.connect:
        t, f = f"fuse_convs_dict.{r}", f"fuse_convs_{r}"
        if net.multiscale_sft:
            e.res_block(f"{t}.encode_enc", f"{f}/encode_enc")
            e.conv2d(f"{t}.scale.0", f"{f}/scale1")
            e.conv2d(f"{t}.scale.2", f"{f}/scale2")
            e.conv2d(f"{t}.shift.0", f"{f}/shift1")
            e.conv2d(f"{t}.shift.2", f"{f}/shift2")
        if net.multiscale_feature_fusion:
            e.conv2d(f"fuse_ms_dict.{r}", f"fuse_ms_{r}")
    e.conv2d("motion_emb.0", "motion_emb_conv")
    e.conv2d("motion_emb.1.conv", "motion_emb_down/conv")
    e.res_block("motion_emb.2", "motion_emb_res")
    e.conv2d("to_motion.0.conv", "to_motion_up/conv")
    e.res_block("to_motion.1", "to_motion_res")
    e.gn("to_motion.2", "to_motion_norm")
    e.conv2d("to_motion.3", "to_motion_conv")
    for i in range(net.n_layers_motion):
        e.transformer_layer(f"motion_block.{i}", f"motion_block_{i}")
    for i in range(net.n_layers_app):
        e.transformer_layer(f"app_block.{i}", f"app_block_{i}")
    if net.MRFA_motion_enc:
        for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
            e.conv2d(f"BasicMotionEncoder.{name}",
                     f"BasicMotionEncoder/{name}")
        for i, r in enumerate(net.scales):  # to_context order == scales
            e.conv2d(f"to_context.{i}", f"to_context_{r}")
        for name in ("convc1", "conv1", "conv2", "convo1", "convo2"):
            e.conv2d(f"refine.{name}", f"refine/{name}")
    if net.warp_s_d_kp_query:
        for r in net.scales:
            e.conv2d(f"warped_source_enc_{r}", f"warped_source_enc_{r}")
        e.conv2d("driving_kp_enc", "driving_kp_enc")
        e.conv2d("motion_query_enc_1", "motion_query_enc_1")
        e.conv2d("motion_query_enc_2", "motion_query_enc_2")
    return e.state_dict()


def net_d_state_dict(variables, n_layers: int = 4) -> Dict[str, torch.Tensor]:
    """VQGANDiscriminator variables -> the port's (reference-named,
    ``main.<i>``) state_dict."""
    e = _Exporter(variables)
    e.conv2d("main.0", "conv0")
    idx = 2
    for n in range(1, n_layers + 1):
        e.conv2d(f"main.{idx}", f"conv{n}")
        e.bn(f"main.{idx + 1}", f"bn{n}")
        idx += 3
    e.conv2d(f"main.{idx}", "conv_out")
    return e.state_dict()


def vgg_state_dict(params) -> Dict[str, torch.Tensor]:
    """VGG19Features params (``conv<i>/Conv_0/{kernel,bias}``) -> the
    torchvision-named state_dict of the port's ``VGG19Features``."""
    e = _Exporter({"params": params})
    for i, idx in enumerate(CONV_INDICES):
        e.conv2d(f"features.{idx}", f"conv{i}")
    return e.state_dict()


def vgg_extractor_state_dict(params) -> Dict[str, torch.Tensor]:
    """VGGFeatureExtractor params (``conv1_1/Conv_0/{kernel,bias}``, ...)
    -> the port's state_dict (``vgg_net.conv1_1.weight``, ...)."""
    e = _Exporter({"params": params})
    for name in params:
        e.conv2d(f"vgg_net.{name}", name)
    return e.state_dict()


# the JAX defaults of the autoencoders' constructors
_AE_DEFAULTS = dict(nf=64, emb_dim=256, ch_mult=(1, 2, 2, 4), res_blocks=2,
                    img_size=256, attn_resolutions=(16,))


def network_state_dict(variables, net_cfg) -> Dict[str, torch.Tensor]:
    """Variables of the JAX network that ``net_cfg`` builds -> the port's
    state_dict, for ``VQAutoEncoder``, ``AutoEncoder``,
    ``AutoEncoder_MSDecoder`` and ``VGGFeatureExtractor`` (by ``type``),
    and ``GumbelQuantizer`` and ``FuseFeatBlock`` (not registered in
    either package; ``type`` names the class)."""
    kind = net_cfg["type"]
    params = variables["params"]
    e = _Exporter(variables)
    if kind == "VGGFeatureExtractor":
        return vgg_extractor_state_dict(params)
    if kind == "GumbelQuantizer":
        e.conv2d("proj", "proj")
        e.direct("embed.weight", "embed")
        return e.state_dict()
    if kind == "FuseFeatBlock":
        e.res_block("encode_enc", "encode_enc")
        return e.state_dict()
    c = {**_AE_DEFAULTS, **net_cfg}
    args = (c["nf"], c["emb_dim"], c["ch_mult"], c["res_blocks"],
            c["img_size"], c["attn_resolutions"])
    e.block_list(encoder_block_defs(*args), "encoder.blocks",
                 "encoder/blocks")
    if kind == "VQAutoEncoder":
        e.direct("quantize.embedding.weight", "quantize/embedding")
    if kind in ("VQAutoEncoder", "AutoEncoder"):
        e.block_list(generator_block_defs(*args), "generator.blocks",
                     "generator/blocks")
    elif kind == "AutoEncoder_MSDecoder":
        with torch.device("meta"):  # structure only
            net = build_network(net_cfg)
        e.modules_by_kind(net.generator, "generator", "generator")
    else:
        raise KeyError(f"no weight map for {kind!r}")
    return e.state_dict()


def _map_block(e: "_Exporter", module, t: str, f: str) -> None:
    """Map port ``module`` (torch key prefix ``t``, "" at the top) from
    the flax params at path ``f``: a leaf by its kind, anything else
    child by child, under the JAX name of each child."""
    def key(name):
        return f"{t}.{name}" if t else name

    def path(name):
        return f"{f}/{name}" if f else name

    if isinstance(module, torch.nn.Conv3d):
        e.sd[key("weight")] = e._get(e.params, path("kernel")).transpose(
            4, 3, 0, 1, 2)
        e.sd[key("bias")] = e._get(e.params, path("bias"))
        return
    if isinstance(module, torch.nn.Conv2d):
        e.conv2d(t, f)
        return
    if isinstance(module, BatchNorm2d):
        e.bn(t, f)
        return
    if isinstance(module, extended_blocks.WNConv2d):
        e.sd[key("weight_v")] = e._get(e.params, path("v")).transpose(
            3, 2, 0, 1)
        e.sd[key("weight_g")] = e._get(e.params, path("g")).reshape(
            -1, 1, 1, 1)
        e.sd[key("bias")] = e._get(e.params, path("bias"))
        return
    if isinstance(module, arch_util.ModulatedDeformConvPack):
        e.sd[key("weight")] = e._get(e.params, path("weight")).transpose(
            3, 2, 0, 1)
        e.direct(key("bias"), path("bias"))
    for name, child in module.named_children():
        if isinstance(module, (motion_blocks.HourglassEncoder,
                               motion_blocks.HourglassDecoder)):
            stem = ("down" if isinstance(module,
                                         motion_blocks.HourglassEncoder)
                    else "up")
            for i, block in enumerate(child):  # down_blocks / up_blocks
                _map_block(e, block, f"{key(name)}.{i}", path(f"{stem}_{i}"))
            continue
        if isinstance(module, arch_util.Upsample):
            jax_name = f"conv{int(name) // 2}"
        elif isinstance(module, torch.nn.Sequential):  # make_layer's
            jax_name = f"block{name}"
        elif isinstance(module, extended_blocks.UpBlock3d) and \
                name == "conv":  # an unnamed flax nn.Conv
            jax_name = "Conv_0"
        else:
            jax_name = name
        _map_block(e, child, key(name), path(jax_name))


def block_state_dict(variables, module) -> Dict[str, torch.Tensor]:
    """The flax variables (``params`` and, for BatchNorm,
    ``batch_stats``) of a JAX module of models/arch_util.py or
    models/extended_blocks.py -> the state_dict of ``module``, its port
    counterpart built with the same sizes."""
    e = _Exporter(variables)
    _map_block(e, module, "", "")
    return e.state_dict()


def _param_part(sd, module) -> Dict[str, torch.Tensor]:
    """The entries of ``sd`` that are parameters of ``module``."""
    names = dict(module.named_parameters())
    return {k: v for k, v in sd.items() if k in names}


def _scale_by_adam_state(opt_state):
    """The ``scale_by_adam`` state of an optimizer state: the state itself,
    or the first part of the chain with ``add_decayed_weights`` that a
    nonzero ``weight_decay`` builds (whose own state is empty)."""
    if hasattr(opt_state, "mu"):
        return opt_state
    return next(s for s in opt_state if hasattr(s, "mu"))


def load_train_state(trainer, jax_state, vgg_params=None) -> None:
    """Load a JAX ``TrainState`` (training/trainer.py:51: step, params and
    BatchNorm statistics of the three networks, the generator's EMA, and
    the ``optax.scale_by_adam`` states ``opt_g/m/d`` with count, mu and
    nu, alone or chained with ``add_decayed_weights``), and optionally the VGG19Features params, into ``trainer``: its
    modules' weights and statistics, and its ``state``. Leaves may be JAX
    or numpy arrays."""
    from .training import AdamState, TrainState

    opt = trainer.opt
    g_cfg, me_cfg = opt["network_g"], opt["network_motion_estimator"]
    n_layers = opt["network_d"].get("n_layers", 4)
    st = jax_state

    def g_sd(tree):
        return net_g_state_dict({"params": tree}, g_cfg)

    def m_sd(tree):
        return motion_estimator_state_dict(
            {"params": tree, "batch_stats": st.stats_m}, me_cfg)

    def d_sd(tree):
        return net_d_state_dict({"params": tree, "batch_stats": st.stats_d},
                                n_layers)

    dev = trainer.device
    modules = ((trainer.net_g, g_sd, st.params_g, st.opt_g, "opt_g"),
               (trainer.motion_estimator, m_sd, st.params_m, st.opt_m,
                "opt_m"),
               (trainer.net_d, d_sd, st.params_d, st.opt_d, "opt_d"))
    adam = {}
    for module, to_sd, params, opt_state, name in modules:
        module.load_state_dict(to_sd(params), strict=True)

        def moments(tree):  # copies: the state is updated in place
            return {k: v.to(dev, copy=True) for k, v in
                    _param_part(to_sd(tree), module).items()}

        adam_state = _scale_by_adam_state(opt_state)
        adam[name] = AdamState(int(np.asarray(adam_state.count)),
                               moments(adam_state.mu),
                               moments(adam_state.nu))
    if vgg_params is not None:
        trainer.vgg.load_state_dict(vgg_state_dict(vgg_params), strict=True)
    trainer.reset_optimizers(int(np.asarray(st.step)))
    trainer.state = TrainState(
        step=trainer.state.step,
        ema_g={k: v.to(dev, copy=True) for k, v in g_sd(st.ema_g).items()},
        **adam)
