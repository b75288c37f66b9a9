"""JAX → port weights: flax variables of the ported models → the port's state_dict.

The port's own inverse of `openstereo_tpu/utils/torch_convert.py`
(`conv_kernel`, `deconv_kernel`, `TreeBuilder`, `convert_lightstereo`,
`convert_sttr`, `convert_gwcnet`, `convert_psmnet`, `convert_coex`,
`convert_msnet3d`, `convert_msnet2d`); it copies none of that code by
import. Layout rules, inverted:

- conv kernel (kh,kw,in,out) → weight (out,in,kh,kw); 3D (kd,kh,kw,in,out)
  → (out,in,kd,kh,kw);
- deconv kernel: un-mirror on every spatial axis, then (in,out,kh,kw) or
  (in,out,kd,kh,kw);
- bn/scale, bn/bias + batch_stats bn/mean, bn/var → weight, bias,
  running_mean, running_var (and num_batches_tracked = 0);
- raw convs (the attention module's) keep their bias;
- Dense kernel (in,out) → weight (out,in); the q/k/v Dense layers of an
  attention module pack into in_proj_weight [3C,C] and in_proj_bias [3C];
- LayerNorm scale/bias → weight/bias;
- weight-normed conv g [O], v (kh,kw,in,out), b → weight_g [O,1,1,1],
  weight_v (out,in,kh,kw), bias.

Inputs are nested dicts of arrays (numpy or anything `np.asarray` takes).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _conv_weight(k: np.ndarray) -> np.ndarray:
    if k.ndim == 5:
        return k.transpose(4, 3, 0, 1, 2)
    return k.transpose(3, 2, 0, 1)


def _deconv_weight(k: np.ndarray) -> np.ndarray:
    if k.ndim == 5:
        return k[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
    return k[::-1, ::-1].transpose(2, 3, 0, 1)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, path)
        else:
            yield path


def _join(*parts: str, sep: str = "/") -> str:
    return sep.join(p for p in parts if p)


class FlaxToTorch:
    """Walks flax variables, writing torch state_dict entries; every flax
    leaf must be consumed (`finish`). Paths are '/'-joined flax module paths
    ('' for the root), keys dotted torch module paths."""

    def __init__(self, variables):
        self.trees = {"params": variables["params"],
                      "batch_stats": variables.get("batch_stats", {})}
        self.used = set()
        self.sd: Dict[str, torch.Tensor] = {}

    def has(self, collection: str, path: str) -> bool:
        tree = self.trees[collection]
        for part in path.split("/"):
            if part not in tree:
                return False
            tree = tree[part]
        return True

    def take(self, collection: str, path: str) -> np.ndarray:
        tree = self.trees[collection]
        for part in path.split("/"):
            tree = tree[part]
        self.used.add(f"{collection}/{path}")
        return np.asarray(tree)

    def put(self, key: str, value: np.ndarray):
        if key in self.sd:
            raise ValueError(f"duplicate target {key}")
        self.sd[key] = torch.from_numpy(np.ascontiguousarray(value))

    def conv(self, fpath: str, tkey: str, deconv: bool = False, raw: bool = False):
        """fpath/{conv|deconv}/kernel[,bias] (or fpath/kernel[,bias] when raw)."""
        base = fpath if raw else _join(fpath, "deconv" if deconv else "conv")
        k = self.take("params", _join(base, "kernel"))
        self.put(f"{tkey}.weight", _deconv_weight(k) if deconv else _conv_weight(k))
        if self.has("params", _join(base, "bias")):
            self.put(f"{tkey}.bias", self.take("params", _join(base, "bias")))

    def dense(self, fpath: str, tkey: str):
        self.put(f"{tkey}.weight", self.take("params", _join(fpath, "kernel")).T)
        self.put(f"{tkey}.bias", self.take("params", _join(fpath, "bias")))

    def layer_norm(self, fpath: str, tkey: str):
        self.put(f"{tkey}.weight", self.take("params", _join(fpath, "scale")))
        self.put(f"{tkey}.bias", self.take("params", _join(fpath, "bias")))

    def bn(self, fpath: str, tkey: str):
        self.put(f"{tkey}.weight", self.take("params", _join(fpath, "bn/scale")))
        self.put(f"{tkey}.bias", self.take("params", _join(fpath, "bn/bias")))
        self.put(f"{tkey}.running_mean", self.take("batch_stats", _join(fpath, "bn/mean")))
        self.put(f"{tkey}.running_var", self.take("batch_stats", _join(fpath, "bn/var")))
        self.sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def convbn(self, fpath: str, tprefix: str, deconv: bool = False):
        """ConvBlock/DeconvBlock at fpath → Sequential(conv, bn) at tprefix."""
        self.conv(fpath, f"{tprefix}.0", deconv=deconv)
        self.bn(fpath, f"{tprefix}.1")

    def finish(self) -> Dict[str, torch.Tensor]:
        unused = [f"{c}/{p}" for c, tree in self.trees.items() for p in _leaves(tree)
                  if f"{c}/{p}" not in self.used]
        if unused:
            raise ValueError(f"{len(unused)} flax variables not consumed, e.g. {unused[:8]}")
        return self.sd


def _trunk(b: FlaxToTorch, fpre: str, tpre: str, sliced: bool = False):
    """flax MobileNetV2Features at fpre → the port's trunk keys at tpre, in
    LightStereo's layout or (`sliced`) CoEx's (`backbones/mobilenetv2.py`)."""
    b.conv(f"{fpre}/stem", f"{tpre}.conv_stem")
    b.bn(f"{fpre}/stem", f"{tpre}.bn1")
    ds = f"{tpre}.block0.0" + (".0" if sliced else "")
    b.conv(f"{fpre}/stage0_block0/dw", f"{ds}.conv_dw")
    b.bn(f"{fpre}/stage0_block0/dw", f"{ds}.bn1")
    b.conv(f"{fpre}/stage0_block0/pw_linear", f"{ds}.conv_pw")
    b.bn(f"{fpre}/stage0_block0/pw_linear", f"{ds}.bn2")
    layout = {"block1": [(1, 2)], "block2": [(2, 3)],
              "block3": [(3, 4), (4, 3)], "block4": [(5, 3)]}
    for blk, stages in layout.items():
        for m, (si, n) in enumerate(stages):
            mid = f".{m}" if sliced else (f".{si}" if blk == "block3" else "")
            for bi in range(n):
                f, t = f"{fpre}/stage{si}_block{bi}", f"{tpre}.{blk}{mid}.{bi}"
                for sub, conv, bn in (("pw", "conv_pw", "bn1"), ("dw", "conv_dw", "bn2"),
                                      ("pw_linear", "conv_pwl", "bn3")):
                    b.conv(f"{f}/{sub}", f"{t}.{conv}")
                    b.bn(f"{f}/{sub}", f"{t}.{bn}")


def mv2_residual(b: FlaxToTorch, fpre: str, tpre: str):
    """flax MobileV2Residual at fpre → port MobileV2Residual keys at tpre."""
    b.convbn(_join(fpre, "pw"), _join(tpre, "pwconv", sep="."))
    b.convbn(_join(fpre, "dw"), _join(tpre, "dwconv", sep="."))
    b.convbn(_join(fpre, "pw_linear"), _join(tpre, "pwliner", sep="."))


def _fpn(b: FlaxToTorch, fpre: str, tpre: str):
    b.convbn(f"{fpre}/deconv", f"{tpre}.deconv.block", deconv=True)
    b.convbn(f"{fpre}/conv", f"{tpre}.conv.block")


def lightstereo_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax LightStereo (S/M/L) {"params", "batch_stats"} → port state_dict.

    Block counts are read from the variables, so one function covers every
    aggregation depth. Raises if a flax variable is left unconsumed.
    """
    b = FlaxToTorch(variables)
    _trunk(b, "backbone/trunk", "backbone")
    for f, t in (("fpn4", "fpn_layer4"), ("fpn3", "fpn_layer3"), ("fpn2", "fpn_layer2")):
        _fpn(b, f"backbone/{f}", f"backbone.{t}")
    b.conv("backbone/out_conv", "backbone.out_conv.block.0")

    agg = b.trees["params"]["cost_agg"]
    count = lambda name: sum(1 for k in agg if k.startswith(f"{name}_"))  # noqa: E731
    for i in range(count("conv0")):
        mv2_residual(b, f"cost_agg/conv0_{i}", f"cost_agg.conv0.{i}")
    mv2_residual(b, "cost_agg/down1", "cost_agg.conv1")
    for i in range(count("conv2")):
        mv2_residual(b, f"cost_agg/conv2_{i}", f"cost_agg.conv2.{i}")
    mv2_residual(b, "cost_agg/down3", "cost_agg.conv3")
    for i in range(count("conv4")):
        mv2_residual(b, f"cost_agg/conv4_{i}", f"cost_agg.conv4.{i}")
    for att in ("att0", "att2", "att4"):
        if att not in agg:
            continue
        f, t = f"cost_agg/{att}", f"cost_agg.{att}"
        b.conv(f"{f}/proj", f"{t}.conv0", raw=True)
        for i, strip in enumerate(("strip7", "strip11", "strip21")):
            b.conv(f"{f}/{strip}_h", f"{t}.conv{i}_1", raw=True)
            b.conv(f"{f}/{strip}_v", f"{t}.conv{i}_2", raw=True)
        b.conv(f"{f}/out", f"{t}.conv3", raw=True)
    b.convbn("cost_agg/up5", "cost_agg.conv5", deconv=True)
    b.convbn("cost_agg/up6", "cost_agg.conv6", deconv=True)
    mv2_residual(b, "cost_agg/redir1", "cost_agg.redir1")
    mv2_residual(b, "cost_agg/redir2", "cost_agg.redir2")

    b.conv("refine1a", "refine_1.0.block.0")
    b.conv("refine1b", "refine_1.1.block.0")
    b.convbn("stem2a", "stem_2.0.block")
    b.convbn("stem2b", "stem_2.1.block")
    _fpn(b, "refine2", "refine_2")
    b.conv("refine3", "refine_3.block.0", deconv=True)
    return b.finish()



def _mha_relative(b: FlaxToTorch, fpath: str, tkey: str):
    """flax q/k/v/out Dense layers → packed in_proj_weight/bias and out_proj."""
    names = ("q_proj", "k_proj", "v_proj")
    b.put(_join(tkey, "in_proj_weight", sep="."), np.concatenate(
        [b.take("params", _join(fpath, n, "kernel")).T for n in names]))
    b.put(_join(tkey, "in_proj_bias", sep="."), np.concatenate(
        [b.take("params", _join(fpath, n, "bias")) for n in names]))
    b.dense(_join(fpath, "out_proj"), _join(tkey, "out_proj", sep="."))


def _wn_conv(b: FlaxToTorch, fpath: str, tkey: str):
    b.put(f"{tkey}.weight_g", b.take("params", f"{fpath}/g").reshape(-1, 1, 1, 1))
    b.put(f"{tkey}.weight_v", _conv_weight(b.take("params", f"{fpath}/v")))
    b.put(f"{tkey}.bias", b.take("params", f"{fpath}/b"))


def _count(tree, test) -> int:
    return sum(1 for key in tree if test(key))


def sttr_backbone(b: FlaxToTorch, fpre: str, tpre: str):
    """flax SppBackboneIN at fpre → port SppBackboneIN keys at tpre."""
    f, t = (lambda *p: _join(fpre, *p)), (lambda *p: _join(tpre, *p, sep="."))  # noqa: E731
    for ti, fi in ((0, 0), (3, 1), (6, 2)):
        b.conv(f(f"in_conv{fi}"), t("in_conv", str(ti)))
    for blk, name in (("resblock_1", "res1"), ("resblock_2", "res2")):
        for i in range(3):
            for c in ("conv1", "conv2"):
                b.conv(f(f"{name}_{i}", c), t(blk, str(i), c))
        b.conv(f(f"{name}_0", "downsample"), t(blk, "0", "downsample", "0"))
    for k in range(4):
        b.conv(f(f"branch{k}"), t(f"branch{k + 1}", "1"))


def sttr_tokenizer(b: FlaxToTorch, fpre: str, tpre: str):
    """flax Tokenizer at fpre → port Tokenizer keys at tpre."""
    f, t = (lambda *p: _join(fpre, *p)), (lambda *p: _join(tpre, *p, sep="."))  # noqa: E731
    tree = b.trees["params"][fpre] if fpre else b.trees["params"]
    for name, blk in (("bottleneck", "bottle_neck"), ("dense0", "dense_block.0"),
                      ("dense1", "dense_block.1")):
        for li in range(_count(tree[name], lambda k: k.startswith("conv1_"))):
            for ci in (1, 2):
                b.conv(f(name, f"conv{ci}_{li}"), t(blk, f"denselayer{li + 1}", f"conv{ci}"),
                       raw=True)
    b.conv(f("up0", "up1"), t("up.0.convTrans"), deconv=True, raw=True)
    b.conv(f("up1", "up1"), t("up.1.convTrans"), deconv=True, raw=True)
    b.conv(f("up2", "up1"), t("up.2.convTrans.0"), deconv=True, raw=True)
    b.conv(f("up2", "up2"), t("up.2.convTrans.2"), deconv=True, raw=True)
    b.conv(f("final0"), t("dense_block.2.double_conv.0"))
    b.conv(f("final1"), t("dense_block.2.double_conv.3"))


def sttr_transformer(b: FlaxToTorch, fpre: str, tpre: str):
    """flax Transformer at fpre → port Transformer keys at tpre, with the
    reference's unused final `norm` set to ones and zeros."""
    f, t = (lambda *p: _join(fpre, *p)), (lambda *p: _join(tpre, *p, sep="."))  # noqa: E731
    tree = b.trees["params"][fpre] if fpre else b.trees["params"]
    for i in range(_count(tree, lambda k: k.startswith("self_"))):
        b.layer_norm(f(f"self_{i}", "norm1"), t(f"self_attn_layers.{i}.norm1"))
        _mha_relative(b, f(f"self_{i}", "self_attn"), t(f"self_attn_layers.{i}.self_attn"))
        for norm in ("norm1", "norm2"):
            b.layer_norm(f(f"cross_{i}", norm), t(f"cross_attn_layers.{i}.{norm}"))
        _mha_relative(b, f(f"cross_{i}", "cross_attn"), t(f"cross_attn_layers.{i}.cross_attn"))
    c = b.sd[t("self_attn_layers.0.norm1.weight")].shape[0]
    b.put(t("norm.weight"), np.ones(c, np.float32))
    b.put(t("norm.bias"), np.zeros(c, np.float32))


def sttr_cal(b: FlaxToTorch, fpre: str, tpre: str):
    """flax ContextAdjustmentLayer at fpre → port keys at tpre."""
    f, t = (lambda *p: _join(fpre, *p)), (lambda *p: _join(tpre, *p, sep="."))  # noqa: E731
    tree = b.trees["params"][fpre] if fpre else b.trees["params"]
    b.conv(f("in_conv"), t("in_conv"), raw=True)
    b.conv(f("out_conv"), t("out_conv"), raw=True)
    for i in range(_count(tree, lambda k: k.endswith("_a"))):
        _wn_conv(b, f(f"res{i}_a"), t(f"layers.{i}.module.0"))
        _wn_conv(b, f(f"res{i}_b"), t(f"layers.{i}.module.2"))
    for ti, fi in ((0, 0), (1, 1), (3, 2), (4, 3)):
        _wn_conv(b, f(f"occ{fi}"), t(f"occ_head.{ti}"))
    b.conv(f("occ4"), t("occ_head.6"), raw=True)


def sttr_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax STTR {"params"} → port state_dict (the reference's key names).

    The attention depth, the dense-block depths and the CAL block count are
    read from the variables. Raises if a flax variable is left unconsumed.
    """
    b = FlaxToTorch(variables)
    sttr_backbone(b, "backbone", "backbone")
    sttr_tokenizer(b, "tokenizer", "tokenizer")
    sttr_transformer(b, "transformer", "transformer")
    b.put("regression_head.phi", np.asarray(b.take("params", "phi"), np.float32).reshape(()))
    sttr_cal(b, "cal", "regression_head.cal")
    return b.finish()


def res_block(b: FlaxToTorch, fpre: str, tpre: str, nested: bool = False):
    """flax ResBlock at fpre → port ResBlock keys at tpre (conv1.{0,1}, or
    conv1.0.{0,1} when `nested`, as GwcNet's reference)."""
    f, t = (lambda *p: _join(fpre, *p)), (lambda *p: _join(tpre, *p, sep="."))  # noqa: E731
    b.convbn(f("conv1"), t("conv1.0") if nested else t("conv1"))
    b.convbn(f("conv2"), t("conv2"))
    if b.has("params", f("downsample")):
        b.convbn(f("downsample"), t("downsample"))


def _res_layers(b: FlaxToTorch, fpre: str, tpre: str, nested: bool):
    for layer, n in (("layer1", 3), ("layer2", 16), ("layer3", 3), ("layer4", 3)):
        for i in range(n):
            res_block(b, _join(fpre, f"{layer}_{i}"), _join(tpre, f"{layer}.{i}", sep="."),
                      nested)


def gwc_backbone(b: FlaxToTorch, fpre: str, tpre: str):
    """flax GwcBackbone at fpre → port GwcBackbone keys at tpre."""
    for i in range(3):
        b.convbn(_join(fpre, f"firstconv{i}"), _join(tpre, f"firstconv.{2 * i}", sep="."))
    _res_layers(b, fpre, tpre, nested=True)
    if b.has("params", _join(fpre, "lastconv0")):
        b.convbn(_join(fpre, "lastconv0"), _join(tpre, "lastconv.0", sep="."))
        b.conv(_join(fpre, "lastconv1"), _join(tpre, "lastconv.2", sep="."))


def gwc_hourglass(b: FlaxToTorch, fpre: str, tpre: str):
    """flax GwcHourglass at fpre → port GwcHourglass keys at tpre."""
    f, t = (lambda *p: _join(fpre, *p)), (lambda *p: _join(tpre, *p, sep="."))  # noqa: E731
    for i in (1, 2, 3, 4):
        b.convbn(f(f"conv{i}"), t(f"conv{i}.0"))
    for i in (5, 6):
        b.convbn(f(f"conv{i}"), t(f"conv{i}"), deconv=True)
    for r in ("redir1", "redir2"):
        b.convbn(f(r), t(r))


def gwcnet_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax GwcNet {"params", "batch_stats"}, drawn with the training heads
    (classif0-classif3), → port state_dict (the reference's key names, as
    `torch_convert.convert_gwcnet` reads them). Raises if a flax variable is
    left unconsumed."""
    b = FlaxToTorch(variables)
    gwc_backbone(b, "backbone", "Backbone.feature_extraction")
    dp = "DispProcessor"
    for f, t in (("dres0a", "dres0.0"), ("dres0b", "dres0.2"),
                 ("dres1a", "dres1.0"), ("dres1b", "dres1.2")):
        b.convbn(f, f"{dp}.{t}")
    for hg in ("dres2", "dres3", "dres4"):
        gwc_hourglass(b, hg, f"{dp}.{hg}")
    for j in range(4):
        b.convbn(f"classif{j}a", f"{dp}.classif{j}.0")
        b.conv(f"classif{j}b", f"{dp}.classif{j}.2")
    return b.finish()


def spp_backbone(b: FlaxToTorch, fpre: str, tpre: str):
    """flax SPPBackbone at fpre → port SPPBackbone keys at tpre."""
    f, t = (lambda *p: _join(fpre, *p)), (lambda *p: _join(tpre, *p, sep="."))  # noqa: E731
    for i in range(3):
        b.convbn(f(f"firstconv{i}"), t(f"firstconv.{i}"))
    _res_layers(b, fpre, tpre, nested=False)
    for k in range(1, 5):  # flax branch0..3 pool 64..8 = reference branch1..4
        b.convbn(f(f"branch{k - 1}"), t(f"branch{k}.1"))
    b.convbn(f("lastconv0"), t("lastconv.0"))
    b.conv(f("lastconv1"), t("lastconv.1"))


def psm_hourglass(b: FlaxToTorch, fpre: str, tpre: str):
    """flax Hourglass3D at fpre → port Hourglass3D keys at tpre."""
    for i in (1, 2, 3, 4):
        b.convbn(_join(fpre, f"conv{i}"), _join(tpre, f"conv{i}", sep="."))
    for i in (5, 6):
        b.convbn(_join(fpre, f"conv{i}"), _join(tpre, f"conv{i}", sep="."), deconv=True)


def psmnet_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax PSMNet {"params", "batch_stats"} → port state_dict (the reference's
    key names, as `torch_convert.convert_psmnet` reads them). Raises if a flax
    variable is left unconsumed."""
    b = FlaxToTorch(variables)
    spp_backbone(b, "backbone", "Backbone")
    agg = "CostProcessor.aggregator"
    for f, t in (("dres0a", "dres0.0"), ("dres0b", "dres0.1"),
                 ("dres1a", "dres1.0"), ("dres1b", "dres1.1")):
        b.convbn(f, f"{agg}.{t}")
    for hg in ("dres2", "dres3", "dres4"):
        psm_hourglass(b, hg, f"{agg}.{hg}")
    for j in (1, 2, 3):
        b.convbn(f"classif{j}a", f"{agg}.classif{j}.0")
        b.conv(f"classif{j}b", f"{agg}.classif{j}.1")
    return b.finish()


def basic_conv(b: FlaxToTorch, fpath: str, tkey: str, bn: bool = True, deconv: bool = False):
    """flax BasicConvBN at fpath (its ConvBlock/DeconvBlock is `conv`) → port
    BasicConvBN keys tkey.conv, tkey.bn."""
    b.conv(_join(fpath, "conv"), _join(tkey, "conv", sep="."), deconv=deconv)
    if bn:
        b.bn(_join(fpath, "conv"), _join(tkey, "bn", sep="."))


def conv2x(b: FlaxToTorch, fpath: str, tkey: str):
    """flax Conv2x (deconv, BatchNorm) → port Conv2x keys."""
    basic_conv(b, _join(fpath, "conv1"), _join(tkey, "conv1", sep="."), deconv=True)
    basic_conv(b, _join(fpath, "conv2"), _join(tkey, "conv2", sep="."))


def feature_att(b: FlaxToTorch, fpath: str, tkey: str):
    """flax FeatureAtt (att0, att1) → port FeatureAtt keys at tkey (its
    Sequential's name included: `tkey` ends in im_att or feat_att)."""
    basic_conv(b, _join(fpath, "att0"), f"{tkey}.0")
    b.conv(_join(fpath, "att1"), f"{tkey}.1", raw=True)


def _basic_conv_bn_pair(b: FlaxToTorch, fa: str, fb: str, tkey: str):
    """flax BasicConvBN fa then fb (relu off) → Sequential(BasicConvBN, conv, BN)."""
    basic_conv(b, fa, f"{tkey}.0")
    b.conv(f"{fb}/conv", f"{tkey}.1")
    b.bn(f"{fb}/conv", f"{tkey}.2")


def coex_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax CoExNet {"params", "batch_stats"} → port state_dict (the
    reference's key names, as `torch_convert.convert_coex` reads them; the
    reference-only modules it drops are not in the port). Block counts are
    read from the variables. Raises if a flax variable is left unconsumed."""
    b = FlaxToTorch(variables)
    _trunk(b, "trunk", "Backbone.feat", sliced=True)
    for name in ("deconv32_16", "deconv16_8", "deconv8_4"):
        conv2x(b, f"up/{name}", f"Backbone.up.{name}")
    basic_conv(b, "up/conv4", "Backbone.up.conv4")
    for s in ("2", "4"):
        _basic_conv_bn_pair(b, f"stem_{s}a", f"stem_{s}b", f"Backbone.stem_{s}")
    cp = "CostProcessor"
    basic_conv(b, "cv_conv", f"{cp}.cost_volume.conv")
    b.conv("cv_desc", f"{cp}.cost_volume.desc", raw=True)
    agg = f"{cp}.cost_agg"
    params = b.trees["params"]
    basic_conv(b, "conv_stem", f"{agg}.conv_stem")
    if "att_stem" in params:
        feature_att(b, "att_stem", f"{agg}.channelAttStem.im_att")
    for i in range(3):
        for n in range(_count(params, lambda k: k.startswith(f"down{i}_"))):
            basic_conv(b, f"down{i}_{n}", f"{agg}.conv_down.{i}.{n}")
        if f"att_down{i}" in params:
            feature_att(b, f"att_down{i}", f"{agg}.channelAttDown.{i}.im_att")
    for j in range(3):
        basic_conv(b, f"up{j}", f"{agg}.conv_up.{j}", bn=j != 0, deconv=True)
    for j in (1, 2):
        basic_conv(b, f"skip{j}", f"{agg}.conv_skip.{j}")
        basic_conv(b, f"agg{j}a", f"{agg}.conv_agg.{j}.0")
        basic_conv(b, f"agg{j}b", f"{agg}.conv_agg.{j}.1")
        if f"att_up{j}" in params:
            feature_att(b, f"att_up{j}", f"{agg}.channelAtt.{j}.im_att")
    dp = "DispProcessor"
    _basic_conv_bn_pair(b, "spx_4a", "spx_4b", f"{dp}.spx_4")
    conv2x(b, "spx_2", f"{dp}.spx_2")
    b.conv("spx", f"{dp}.spx.0", deconv=True, raw=True)
    return b.finish()


def msnet_mv2(b: FlaxToTorch, fpath: str, tkey: str):
    """flax MobileV2Residual / MobileV2Residual3D at fpath → port
    MobileV2ResidualSeq / MobileV2Residual3D keys tkey.conv.{0,1,3,4,6,7}."""
    for (ci, bi), sub in (((0, 1), "pw"), ((3, 4), "dw"), ((6, 7), "pw_linear")):
        b.conv(_join(fpath, sub), _join(tkey, f"conv.{ci}", sep="."))
        b.bn(_join(fpath, sub), _join(tkey, f"conv.{bi}", sep="."))


def msnet_mv1(b: FlaxToTorch, fpath: str, tkey: str):
    """flax MobileV1Residual at fpath → port MobileV1Residual keys at tkey."""
    for conv in ("conv1", "conv2"):
        for (ci, bi), sub in (((0, 1), "dw"), ((3, 4), "pw")):
            b.conv(_join(fpath, f"{conv}_{sub}"), _join(tkey, f"{conv}.{ci}", sep="."))
            b.bn(_join(fpath, f"{conv}_{sub}"), _join(tkey, f"{conv}.{bi}", sep="."))
    if b.has("params", _join(fpath, "downsample")):
        b.convbn(_join(fpath, "downsample"), _join(tkey, "downsample", sep="."))


def msnet_trunk(b: FlaxToTorch, fpre: str, tpre: str, add_relus: bool = False):
    """flax MobileFeatureTrunk at fpre → port MobileFeatureTrunk keys at tpre."""
    f, t = (lambda *p: _join(fpre, *p)), (lambda *p: _join(tpre, *p, sep="."))  # noqa: E731
    for i, ti in enumerate((0, 2, 4) if add_relus else (0, 1, 2)):
        msnet_mv2(b, f(f"firstconv{i}"), t(f"firstconv.{ti}"))
    for layer, n in (("layer1", 3), ("layer2", 16), ("layer3", 3), ("layer4", 3)):
        for i in range(n):
            msnet_mv1(b, f(f"{layer}_{i}"), t(f"{layer}.{i}"))


def msnet_hourglass(b: FlaxToTorch, fpre: str, tpre: str):
    """flax Hourglass2D / Hourglass3DMobile at fpre → port Hourglass keys."""
    f, t = (lambda *p: _join(fpre, *p)), (lambda *p: _join(tpre, *p, sep="."))  # noqa: E731
    for name in ("conv1", "conv2", "conv3", "conv4", "redir1", "redir2"):
        msnet_mv2(b, f(name), t(name))
    for name in ("conv5", "conv6"):
        b.convbn(f(name), t(name), deconv=True)


def msnet_compressor(b: FlaxToTorch, fpre: str, tpre: str):
    """flax InterlacedCompressor at fpre → port `conv3d`, `volume11` keys under tpre."""
    for i, ti in enumerate((0, 3, 6)):
        b.conv(_join(fpre, f"c{i}"), _join(tpre, f"conv3d.{ti}", sep="."))
        b.bn(_join(fpre, f"c{i}"), _join(tpre, f"conv3d.{ti + 1}", sep="."))
    b.convbn(_join(fpre, "volume11"), _join(tpre, "volume11.0", sep="."))


def _msnet_heads(b: FlaxToTorch):
    for i in (1, 2, 3):
        msnet_hourglass(b, f"hg{i}", f"encoder_decoder{i}")
    for j in range(4):
        b.convbn(f"classif{j}a", f"classif{j}.0")
        b.conv(f"classif{j}b", f"classif{j}.2")


def msnet3d_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax MSNet3D {"params", "batch_stats"}, drawn with the training heads
    (classif0-classif3), → port state_dict (the reference's key names, as
    `torch_convert.convert_msnet3d` reads them). Raises if a flax variable is
    left unconsumed."""
    b = FlaxToTorch(variables)
    msnet_trunk(b, "trunk", "feature_extraction")
    for f, t in (("dres0a", "dres0.0"), ("dres0b", "dres0.1"),
                 ("dres1a", "dres1.0"), ("dres1b", "dres1.1")):
        msnet_mv2(b, f, t)
    _msnet_heads(b)
    return b.finish()


def msnet2d_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax MSNet2D {"params", "batch_stats"}, drawn with the training heads,
    → port state_dict (as `torch_convert.convert_msnet2d` reads it). Raises
    if a flax variable is left unconsumed."""
    b = FlaxToTorch(variables)
    msnet_trunk(b, "trunk", "feature_extraction", add_relus=True)
    for i, t in enumerate((0, 2, 4)):
        b.convbn(f"preconv{i}", f"preconv11.{t}")
    b.conv("preconv3", "preconv11.6", raw=True)
    msnet_compressor(b, "compressor", "")
    for f, t in (("dres0a", "dres0.0"), ("dres0b", "dres0.2"),
                 ("dres1a", "dres1.0"), ("dres1b", "dres1.2")):
        msnet_mv2(b, f, t)
    _msnet_heads(b)
    return b.finish()
