"""JAX → port weights: flax variables of the ported models → the port's state_dict.

The port's own inverse of `openstereo_tpu/utils/torch_convert.py`
(`conv_kernel`, `deconv_kernel`, `TreeBuilder`, `convert_lightstereo`,
`convert_sttr`, `convert_gwcnet`, `convert_psmnet`, `convert_coex`,
`convert_msnet3d`, `convert_msnet2d`, `convert_cfnet`, `convert_fadnet`,
`convert_casnet`, `convert_igev`, `convert_igev_rt`, `convert_stereobase`,
`convert_igevpp`, `convert_foundationstereo`, `convert_fastfoundationstereo`,
`convert_monster`);
it copies none of that code by import. Layout rules, inverted:

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
    b.put("regression_head.phi", np.asarray(b.take("params", "phi")).reshape(()))
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


def basic_conv(b: FlaxToTorch, fpath: str, tkey: str, bn: bool = True, deconv: bool = False,
               spelling: str = "igev"):
    """flax BasicConvBN or BasicConvIN at fpath (its ConvBlock/DeconvBlock is
    `conv`; `bn` False for an InstanceNorm or no norm) → port keys tkey.conv,
    tkey.bn, or with `spelling` "block" tkey.block.0, tkey.block.1."""
    ck, nk = ("conv", "bn") if spelling == "igev" else ("block.0", "block.1")
    b.conv(_join(fpath, "conv"), _join(tkey, ck, sep="."), deconv=deconv)
    if bn:
        b.bn(_join(fpath, "conv"), _join(tkey, nk, sep="."))


def conv2x(b: FlaxToTorch, fpath: str, tkey: str, bn: bool = True, spelling: str = "igev"):
    """flax Conv2x (deconv; BatchNorm, or with `bn` False InstanceNorm) → port
    Conv2x keys."""
    basic_conv(b, _join(fpath, "conv1"), _join(tkey, "conv1", sep="."), bn=bn, deconv=True,
               spelling=spelling)
    basic_conv(b, _join(fpath, "conv2"), _join(tkey, "conv2", sep="."), bn=bn, spelling=spelling)


def feature_att(b: FlaxToTorch, fpath: str, tkey: str, bn: bool = True, spelling: str = "igev"):
    """flax FeatureAtt (att0, att1; `bn` False: the InstanceNorm flavour) →
    port FeatureAtt keys at tkey (its Sequential's name included: `tkey` ends
    in im_att or feat_att)."""
    basic_conv(b, _join(fpath, "att0"), f"{tkey}.0", bn=bn, spelling=spelling)
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


def _seq_convbn(b: FlaxToTorch, fpath: str, tkey: str):
    """flax ConvBlock with BatchNorm at fpath → Sequential(convbn, act) at tkey (its `.0`)."""
    b.convbn(fpath, f"{tkey}.0")


def _classif(b: FlaxToTorch, fpre: str, tkey: str):
    """flax `{fpre}a` ConvBlock + `{fpre}b` conv → Sequential(convbn, act, conv) at tkey."""
    b.convbn(f"{fpre}a", f"{tkey}.0")
    b.conv(f"{fpre}b", f"{tkey}.2")


def _dres_pair(b: FlaxToTorch, fpre: str, t0: str, t1: str):
    """flax {fpre}_0a/_0b/_1a/_1b → Sequentials t0.{0,2} and t1.{0,2}."""
    for f, t in (("0a", f"{t0}.0"), ("0b", f"{t0}.2"), ("1a", f"{t1}.0"), ("1b", f"{t1}.2")):
        b.convbn(f"{fpre}_{f}", t)


def cfnet_features(b: FlaxToTorch, fpre: str, tpre: str):
    """flax CFFeatures at fpre → port CFFeatures keys at tpre."""
    f, t = (lambda *p: _join(fpre, *p)), (lambda *p: _join(tpre, *p, sep="."))  # noqa: E731
    for i in range(3):
        b.convbn(f(f"firstconv{i}"), t(f"firstconv.{2 * i}"))
    for li in (2, 3, 4, 5, 6):
        res_block(b, f(f"layer{li}"), t(f"layer{li}.0"), nested=True)
    for i in range(4):
        b.convbn(f(f"psp{i}"), t(f"pyramid_pooling.path_module_list.{i}.cbr_unit"))
    for i in (6, 5, 4, 3):
        b.convbn(f(f"upconv{i}"), t(f"upconv{i}.1"))
        _seq_convbn(b, f(f"iconv{i - 1}"), t(f"iconv{i - 1}"))
    for n in (2, 3, 4, 5, 6):
        for fname, tname in ((f"gw{n}", f"gw{n}"), (f"cat{n}", f"concat{n}")):
            b.convbn(f(f"{fname}a"), t(f"{tname}.0"))
            b.conv(f(f"{fname}b"), t(f"{tname}.2"), raw=True)


def cfnet_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax CFNet {"params", "batch_stats"}, drawn with the training heads,
    → port state_dict (the reference's key names, as
    `torch_convert.convert_cfnet` reads them; the reference-only
    `combine1.combine3`/`redir3` it drops are not in the port). Raises if a
    flax variable is left unconsumed."""
    b = FlaxToTorch(variables)
    cfnet_features(b, "features", "feature_extraction")
    for fpre, suf in (("dres4", ""), ("dres5", "_5"), ("dres6", "_6")):
        _dres_pair(b, fpre, f"dres0{suf}", f"dres1{suf}")
    hu = "combine1"
    b.conv(f"{hu}/conv1", f"{hu}.conv1", raw=True)
    b.conv(f"{hu}/conv3", f"{hu}.conv3", raw=True)
    for name in ("combine1", "combine2", "conv2", "conv4"):
        _seq_convbn(b, f"{hu}/{name}", f"{hu}.{name}")
    for name in ("conv8", "conv9"):
        b.convbn(f"{hu}/{name}", f"{hu}.{name}", deconv=True)
    for name in ("redir1", "redir2"):
        b.convbn(f"{hu}/{name}", f"{hu}.{name}")
    gwc_hourglass(b, "dres3", "dres3")
    for s in ("s3", "s2"):
        _dres_pair(b, f"conf_{s}", f"confidence0_{s}", f"confidence1_{s}")
        gwc_hourglass(b, f"conf2_{s}", f"confidence2_{s}")
        gwc_hourglass(b, f"conf3_{s}", f"confidence3_{s}")
        for head in ("classif0", "classif1", "classifmid"):
            _classif(b, f"conf_{head}_{s}", f"confidence_{head}_{s}")
    for head in ("classif0", "classif1", "classif2"):
        _classif(b, head, head)
    for p in ("gamma_s3", "beta_s3", "gamma_s2", "beta_s2"):
        b.put(p, np.asarray(b.take("params", p), np.float32).reshape(()))
    return b.finish()


def fad_res(b: FlaxToTorch, fpre: str, tpre: str, dyres: bool = False):
    """flax FadResBlock at fpre → port FadResBlock keys at tpre (`.conv` under
    the DynamicConv convs when `dyres`)."""
    f, t = (lambda *p: _join(fpre, *p)), (lambda *p: _join(tpre, *p, sep="."))  # noqa: E731
    dyn = ("conv",) if dyres else ()
    b.conv(f("conv1"), t("conv1", *dyn))
    b.bn(f("conv1"), t("bn1"))
    b.conv(f("conv2"), t("conv2"))
    b.bn(f("conv2"), t("bn2"))
    if b.has("params", f("shortcut")):
        b.conv(f("shortcut"), t("shortcut", "0", *dyn))
        b.bn(f("shortcut"), t("shortcut", "1"))


def fad_decoder(b: FlaxToTorch, fpre: str, tpre: str, pred: str):
    """flax PyramidDecoder at fpre → the port's pyramid keys under tpre
    (`iconvN` a stride-1 transposed conv, as the reference's)."""
    f, t = (lambda *p: _join(fpre, *p)), (lambda *p: _join(tpre, *p, sep="."))  # noqa: E731
    b.conv(f("pred6"), t(f"{pred}6"), raw=True)
    for k in range(5, -1, -1):
        b.conv(f(f"upconv{k}"), t(f"upconv{k}", "0"), deconv=True)
        b.conv(f(f"upflow{k}"), t(f"upflow{k + 1}to{k}"), deconv=True, raw=True)
        b.conv(f(f"iconv{k}"), t(f"iconv{k}"), deconv=True, raw=True)
        b.conv(f(f"pred{k}"), t(f"{pred}{k}"), raw=True)


def fadnet_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax FADNet {"params", "batch_stats"} → port state_dict (the
    reference's key names, as `torch_convert.convert_fadnet` reads them).
    Raises if a flax variable is left unconsumed."""
    b = FlaxToTorch(variables)
    b.conv("conv1", "backbone.conv1.0")
    fad_res(b, "conv2", "backbone.conv2")
    fad_res(b, "conv3", "backbone.conv3")
    cp, dp = "cost_processor", "disp_predictor"
    fad_res(b, "conv_redir", f"{cp}.conv_redir")
    fad_res(b, "conv3_1", f"{cp}.conv3_1", dyres=True)
    b.conv("res_conv1", f"{dp}.conv1.0")
    for name in ("conv2", "conv3", "conv3_1"):
        fad_res(b, f"res_{name}", f"{dp}.{name}")
    for name in ("conv4", "conv4_1", "conv5", "conv5_1", "conv6", "conv6_1"):
        fad_res(b, f"enc456/{name}", f"{cp}.{name}")
        fad_res(b, f"res_enc456/{name}", f"{dp}.{name}")
    fad_decoder(b, "decoder_c", cp, "pred_flow")
    fad_decoder(b, "decoder_res", dp, "pred_res")
    return b.finish()


def _cas_cost_agg(b: FlaxToTorch, fpre: str, tpre: str):
    """flax CasCostAggregation at fpre → port CasCostAggregation keys at tpre."""
    for fname, tname in (("dres0a", "dres0.0"), ("dres0b", "dres0.2"),
                         ("dres1a", "dres1.0"), ("dres1b", "dres1.2")):
        b.convbn(f"{fpre}/{fname}", f"{tpre}.{tname}")
    for hg in ("dres2", "dres3", "dres4"):
        gwc_hourglass(b, f"{fpre}/{hg}", f"{tpre}.{hg}")
    for j in range(4):
        _classif(b, f"{fpre}/classif{j}", f"{tpre}.classif{j}")


def casnet_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax CasPSMNet or CasGwcNet {"params", "batch_stats"}, drawn with the
    training heads, → port state_dict (the reference's key names, as
    `torch_convert.convert_casnet` reads them). The variant and the stage
    count are read from the variables. Raises if a flax variable is left
    unconsumed."""
    b = FlaxToTorch(variables)
    f, t = "features", "feature_extraction"
    b.convbn(f"{f}/firstconv_a0", f"{t}.firstconv_a.0")
    b.convbn(f"{f}/firstconv_a1", f"{t}.firstconv_a.2")
    b.convbn(f"{f}/firstconv_b", f"{t}.firstconv_b.0")
    _res_layers(b, f, t, nested=True)
    feats = b.trees["params"][f]
    # inner1.. carry the finer stages (inner0a/b are CasPSMNet's SPP fusion)
    n_stage = 1 + _count(feats, lambda k: k[:5] == "inner" and k[5:].isdigit() and k != "inner0")
    if "branch0" in feats:  # CasPSMNet: SPP + inner0/lastconv
        for k in range(1, 5):
            b.convbn(f"{f}/branch{k - 1}", f"{t}.branch{k}.1")
        b.convbn(f"{f}/inner0a", f"{t}.inner0.0")
        b.conv(f"{f}/inner0b", f"{t}.inner0.2", raw=True)
        b.conv(f"{f}/lastconv", f"{t}.lastconv", raw=True)
    else:  # CasGwcNet: per-stage concat heads
        b.convbn(f"{f}/out1_cat_a", f"{t}.out1_cat.0")
        b.conv(f"{f}/out1_cat_b", f"{t}.out1_cat.2", raw=True)
        for i in range(1, n_stage):
            b.conv(f"{f}/out{i + 1}_cat", f"{t}.out{i + 1}_cat", raw=True)
    for i in range(1, n_stage):
        b.conv(f"{f}/inner{i}", f"{t}.inner{i}", raw=True)
        b.conv(f"{f}/out{i + 1}", f"{t}.out{i + 1}", raw=True)
    for si in range(n_stage):
        _cas_cost_agg(b, f"cost_agg{si}", f"cost_agg.{si}")
    return b.finish()


HOURGLASS_CONVS = (("conv1a", "conv1.0"), ("conv1b", "conv1.1"), ("conv2a", "conv2.0"),
                   ("conv2b", "conv2.1"), ("conv3a", "conv3.0"), ("conv3b", "conv3.1"),
                   ("agg0a", "agg_0.0"), ("agg0b", "agg_0.1"), ("agg0c", "agg_0.2"),
                   ("agg1a", "agg_1.0"), ("agg1b", "agg_1.1"), ("agg1c", "agg_1.2"))
HOURGLASS_ATTS = (("att8", "feature_att_8"), ("att16", "feature_att_16"),
                  ("att32", "feature_att_32"), ("att_up16", "feature_att_up_16"),
                  ("att_up8", "feature_att_up_8"))


def geo_hourglass(b: FlaxToTorch, fpre: str, tpre: str, spelling: str = "igev"):
    """flax GeoHourglass at fpre → port GeoHourglass keys at tpre."""
    for f, t in HOURGLASS_CONVS:
        basic_conv(b, f"{fpre}/{f}", f"{tpre}.{t}", spelling=spelling)
    for t in ("conv3_up", "conv2_up"):
        basic_conv(b, f"{fpre}/{t}", f"{tpre}.{t}", deconv=True, spelling=spelling)
    basic_conv(b, f"{fpre}/conv1_up", f"{tpre}.conv1_up", bn=False, deconv=True,
               spelling=spelling)
    for f, t in HOURGLASS_ATTS:
        feature_att(b, f"{fpre}/{f}", f"{tpre}.{t}.feat_att", spelling=spelling)


def pp_hourglass(b: FlaxToTorch, fpre: str, tpre: str):
    """flax PPHourglass (InstanceNorm: only the conv kernels and the feature
    attentions' convs carry weights) at fpre → port PPHourglass keys."""
    for f, t in (("conv0", "conv0"),) + HOURGLASS_CONVS:
        basic_conv(b, f"{fpre}/{f}", f"{tpre}.{t}", bn=False)
    for t in ("conv3_up", "conv2_up", "conv1_up"):
        basic_conv(b, f"{fpre}/{t}", f"{tpre}.{t}", bn=False, deconv=True)
    for f, t in (("att4", "feature_att_4"),) + HOURGLASS_ATTS:
        feature_att(b, f"{fpre}/{f}", f"{tpre}.{t}.feat_att", bn=False)


def _ctx_res_block(b: FlaxToTorch, fpre: str, tpre: str):
    """flax ResidualBlockCtx (batch norm) → port ResidualBlockCtx keys."""
    for i in (1, 2):
        b.conv(f"{fpre}/conv{i}", f"{tpre}.conv{i}")
        b.bn(f"{fpre}/conv{i}", f"{tpre}.norm{i}")
    if b.has("params", f"{fpre}/downsample"):
        b.convbn(f"{fpre}/downsample", f"{tpre}.downsample")


def multi_basic_encoder(b: FlaxToTorch, fpre: str, tpre: str):
    """flax MultiBasicEncoder (batch norm) → port MultiBasicEncoder keys; the
    number of outputs is read from the variables."""
    b.conv(f"{fpre}/conv1", f"{tpre}.conv1")
    b.bn(f"{fpre}/conv1", f"{tpre}.norm1")
    for i in range(1, 6):
        for j in (0, 1):
            _ctx_res_block(b, f"{fpre}/layer{i}_{j}", f"{tpre}.layer{i}.{j}")
    n_out = _count(b.trees["params"][fpre], lambda k: k.startswith("out16_"))
    for scale in ("04", "08"):
        for oi in range(n_out):
            _ctx_res_block(b, f"{fpre}/out{scale}_{oi}_res", f"{tpre}.outputs{scale}.{oi}.0")
            b.conv(f"{fpre}/out{scale}_{oi}_conv", f"{tpre}.outputs{scale}.{oi}.1", raw=True)
    for oi in range(n_out):
        b.conv(f"{fpre}/out16_{oi}_conv", f"{tpre}.outputs16.{oi}", raw=True)


def igev_front(b: FlaxToTorch, spx_2_gru_bn: bool = True, spelling: str = "igev"):
    """What the IGEV family's flax models share before the volume: `Feature`,
    the stems, the superpixel heads (`spx_2_gru` with BatchNorm or, IGEV++,
    InstanceNorm) and the descriptors `conv`, `desc`."""
    _trunk(b, "feature/trunk", "feature", sliced=True)
    for name in ("deconv32_16", "deconv16_8", "deconv8_4"):
        conv2x(b, f"feature/{name}", f"feature.{name}", bn=False, spelling=spelling)
    basic_conv(b, "feature/conv4", "feature.conv4", bn=False, spelling=spelling)
    second = ".block.0" if spelling == "block" else ""
    for s in ("stem_2", "stem_4", "spx_4"):
        basic_conv(b, f"{s}a", f"{s}.0", bn=False, spelling=spelling)
        b.conv(f"{s}b", f"{s}.1{second}")
    conv2x(b, "spx_2", "spx_2", bn=False, spelling=spelling)
    b.conv("spx", "spx.0", deconv=True, raw=True)
    conv2x(b, "spx_2_gru", "spx_2_gru", bn=spx_2_gru_bn, spelling=spelling)
    b.conv("spx_gru", "spx_gru.0", deconv=True, raw=True)
    basic_conv(b, "conv", "conv", bn=False, spelling=spelling)
    b.conv("desc", "desc", raw=True)


def _context(b: FlaxToTorch):
    multi_basic_encoder(b, "cnet", "cnet")
    for i in range(3):
        b.conv(f"context_zqr{i}", f"context_zqr_convs.{i}", raw=True)


def update_block(b: FlaxToTorch, grus=("gru04", "gru08", "gru16"),
                 ub: str = "gru_loop/update_block", tb: str = "update_block",
                 encoder: bool = True):
    """flax update block under the scanned loop → port keys: the motion
    encoder (with `encoder`), `grus`, disp_head, mask_feat_4."""
    f, t = (lambda *p: _join(ub, *p)), (lambda *p: _join(tb, *p, sep="."))  # noqa: E731
    for k in ("convc1", "convc2", "convd1", "convd2", "conv") if encoder else ():
        b.conv(f("encoder", k), t("encoder", k), raw=True)
    for g in grus:
        for k in ("convz", "convr", "convq"):
            b.conv(f(g, k), t(g, k), raw=True)
    for k in ("conv1", "conv2"):
        b.conv(f("disp_head", k), t("disp_head", k), raw=True)
    b.conv(f("mask_feat_4"), t("mask_feat_4", "0"), raw=True)


def igev_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax IGEV {"params", "batch_stats"}, drawn with the training heads, →
    port state_dict (the reference's key names, as
    `torch_convert.convert_igev` reads them). Raises if a flax variable is
    left unconsumed."""
    b = FlaxToTorch(variables)
    igev_front(b)
    basic_conv(b, "corr_stem", "corr_stem")
    feature_att(b, "corr_feature_att", "corr_feature_att.feat_att")
    geo_hourglass(b, "cost_agg", "cost_agg")
    b.conv("classifier", "classifier", raw=True)
    _context(b)
    update_block(b)
    return b.finish()


def igev_rt_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax IGEVRT, drawn with the training heads, → port state_dict (as
    `torch_convert.convert_igev_rt` reads it). Raises if a flax variable is
    left unconsumed."""
    b = FlaxToTorch(variables)
    igev_front(b)
    geo_hourglass(b, "cost_agg", "cost_agg")
    b.conv("classifier", "classifier", raw=True)
    basic_conv(b, "hnet0", "hnet.0")
    b.conv("hnet1", "hnet.1", raw=True)
    basic_conv(b, "cnet", "cnet")
    b.conv("context_zqr_conv", "context_zqr_conv", raw=True)
    update_block(b, grus=("gru",))
    return b.finish()


def stereobase_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax StereoBase, drawn with the training heads, → port state_dict in
    StereoBase's key spelling (as `torch_convert.convert_stereobase` reads
    it), with `concat_conv` and `build_interlaced_volume` where the variables
    hold them. Raises if a flax variable is left unconsumed."""
    b = FlaxToTorch(variables)
    igev_front(b, spelling="block")
    if b.has("params", "concat_conv0"):
        b.convbn("concat_conv0", "concat_conv.0.block")
        b.conv("concat_conv1", "concat_conv.1", raw=True)
    if b.has("params", "build_interlaced_volume"):
        iv = "build_interlaced_volume"
        for i in range(3):
            b.convbn(f"{iv}/c{i}", f"{iv}.conv3d.{i}.block")
        b.convbn(f"{iv}/volume11", f"{iv}.volume11.block")
    geo_hourglass(b, "cost_agg", "cost_agg", spelling="block")
    b.conv("classifier", "classifier", raw=True)
    _context(b)
    update_block(b)
    return b.finish()


def igevpp_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax IGEVPP, drawn with the training heads, → port state_dict (as
    `torch_convert.convert_igevpp` reads it). Raises if a flax variable is
    left unconsumed."""
    b = FlaxToTorch(variables)
    igev_front(b, spx_2_gru_bn=False)
    b.conv("patch0", "patch0", raw=True)
    b.conv("patch1", "patch1", raw=True)
    for i in range(3):
        pp_hourglass(b, f"cost_agg{i}", f"cost_agg{i}")
    b.conv("classifier", "classifier", raw=True)
    for i in range(2):
        basic_conv(b, f"disp_conv{i}", f"disp_conv.{i}", bn=False)
        basic_conv(b, f"selective_conv{i}", f"selective_conv.{i}", bn=False)
    b.conv("selective_conv2", "selective_conv.2", raw=True)
    _context(b)
    ub = "gru_loop/update_block"
    for i in range(3):
        for k in ("convg1", "convg2"):
            b.conv(f"{ub}/geo_encoder{i}/{k}", f"update_block.geo_encoder{i}.{k}", raw=True)
    update_block(b)
    return b.finish()


def raw_bn(b: FlaxToTorch, fpath: str, tkey: str):
    """A directly named flax nn.BatchNorm at fpath → BatchNorm keys at tkey."""
    b.put(f"{tkey}.weight", b.take("params", f"{fpath}/scale"))
    b.put(f"{tkey}.bias", b.take("params", f"{fpath}/bias"))
    b.put(f"{tkey}.running_mean", b.take("batch_stats", f"{fpath}/mean"))
    b.put(f"{tkey}.running_var", b.take("batch_stats", f"{fpath}/var"))
    b.sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


EDGENEXT_DEPTHS, EDGENEXT_GLOBAL = (3, 3, 9, 3), (0, 1, 1, 1)


def edgenext(b: FlaxToTorch, fpre: str, tpre: str):
    """flax EdgeNeXtFeatures at fpre → the port's EdgeNeXt keys (stem, stages)
    at tpre."""
    b.conv(f"{fpre}/stem_conv", f"{tpre}.stem.0", raw=True)
    b.layer_norm(f"{fpre}/stem_norm", f"{tpre}.stem.1")
    for s, depth in enumerate(EDGENEXT_DEPTHS):
        sp = f"{tpre}.stages.{s}"
        if s > 0:
            b.layer_norm(f"{fpre}/down{s}_norm", f"{sp}.downsample.0")
            b.conv(f"{fpre}/down{s}_conv", f"{sp}.downsample.1", raw=True)
        n_local = depth - EDGENEXT_GLOBAL[s]
        for i in range(depth):
            fp = (f"{fpre}/stage{s}_block{i}" if i < n_local
                  else f"{fpre}/stage{s}_sdta{i - n_local}")
            edgenext_block(b, fp, f"{sp}.blocks.{i}", i < n_local)


def edgenext_block(b: FlaxToTorch, fp: str, bp: str, local: bool):
    """flax ConvEncoder (`local`) or SDTAEncoder at fp → the port's block keys
    at bp."""
    f, t = (lambda *p: _join(fp, *p)), (lambda *p: _join(bp, *p, sep="."))  # noqa: E731
    if local:
        b.conv(f("dwconv"), t("conv_dw"), raw=True)
    else:
        tree = _subtree(b, fp) if fp else b.trees["params"]
        for ci in range(_count(tree, lambda k: k.startswith("conv"))):
            b.conv(f(f"conv{ci}"), t("convs", str(ci)), raw=True)
        if b.has("params", f("pos_proj")):
            b.put(t("pos_embd.token_projection.weight"),
                  b.take("params", f("pos_proj", "kernel")).T[..., None, None])
            b.put(t("pos_embd.token_projection.bias"), b.take("params", f("pos_proj", "bias")))
        b.layer_norm(f("norm_xca"), t("norm_xca"))
        b.put(t("gamma_xca"), b.take("params", f("gamma_xca")))
        b.put(t("xca.temperature"), b.take("params", f("xca", "temperature")))
        b.dense(f("xca", "qkv"), t("xca.qkv"))
        b.dense(f("xca", "proj"), t("xca.proj"))
    b.layer_norm(f("norm"), t("norm"))
    b.dense(f("pw1"), t("mlp.fc1"))
    b.dense(f("pw2"), t("mlp.fc2"))
    b.put(t("gamma"), b.take("params", f("gamma")))


def dino_vit(b: FlaxToTorch, fpre: str, tpre: str):
    """flax DinoViT at fpre → the port's DinoViT keys at tpre; the depth is
    read from the variables."""
    for k in ("cls_token", "pos_embed"):
        b.put(f"{tpre}.{k}", b.take("params", f"{fpre}/{k}"))
    b.conv(f"{fpre}/patch_embed", f"{tpre}.patch_embed.proj", raw=True)
    depth = _count(_subtree(b, fpre), lambda k: k.startswith("block"))
    for i in range(depth):
        vit_block(b, f"{fpre}/block{i}", f"{tpre}.blocks.{i}")
    b.layer_norm(f"{fpre}/norm", f"{tpre}.norm")


def vit_block(b: FlaxToTorch, fp: str, bp: str):
    """flax ViTBlock at fp → the port's ViTBlock keys at bp."""
    f, t = (lambda *p: _join(fp, *p)), (lambda *p: _join(bp, *p, sep="."))  # noqa: E731
    for n in ("norm1", "norm2"):
        b.layer_norm(f(n), t(n))
    for fk, tk in (("attn/qkv", "attn.qkv"), ("attn/proj", "attn.proj"), ("fc1", "mlp.fc1"),
                   ("fc2", "mlp.fc2")):
        b.dense(f(fk), t(tk))
    for k in ("ls1", "ls2"):
        b.put(t(k, "gamma"), b.take("params", f(k)))


def _subtree(b: FlaxToTorch, path: str):
    tree = b.trees["params"]
    for part in path.split("/"):
        tree = tree[part]
    return tree


def dpt_pyramid_decoder(b: FlaxToTorch, fpre: str, tpre: str):
    """flax DPTPyramidDecoder at fpre → the port's keys at tpre: the
    reassembly and the refinenets (refinenet4 without its first unit)."""
    for i in range(4):
        b.conv(f"{fpre}/project{i}", f"{tpre}.projects.{i}", raw=True)
    for i in (0, 1, 3):
        b.conv(f"{fpre}/resize{i}", f"{tpre}.resize_layers.{i}", deconv=i < 2, raw=True)
    sc = f"{tpre}.scratch"
    for i in range(1, 5):
        b.conv(f"{fpre}/layer{i}_rn", f"{sc}.layer{i}_rn", raw=True)
        rp, fp = f"{sc}.refinenet{i}", f"{fpre}/refinenet{i}"
        for fu, tu in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            if b.has("params", f"{fp}/{fu}"):
                for c in ("conv1", "conv2"):
                    b.conv(f"{fp}/{fu}/{c}", f"{rp}.{tu}.{c}", raw=True)
        b.conv(f"{fp}/out_conv", f"{rp}.out_conv", raw=True)


def dpt_head(b: FlaxToTorch, fpre: str, tpre: str):
    """flax DPTHead at fpre → the port's DPTHead keys at tpre."""
    dpt_pyramid_decoder(b, fpre, tpre)
    sc = f"{tpre}.scratch"
    b.conv(f"{fpre}/output_conv1", f"{sc}.output_conv1", raw=True)
    b.conv(f"{fpre}/output_conv2a", f"{sc}.output_conv2.0", raw=True)
    b.conv(f"{fpre}/output_conv2b", f"{sc}.output_conv2.2", raw=True)


def depth_anything(b: FlaxToTorch, fpre: str, tpre: str):
    """flax DepthAnythingV2 at fpre → the port's keys (pretrained, depth_head)."""
    dino_vit(b, _join(fpre, "pretrained"), _join(tpre, "pretrained", sep="."))
    dpt_head(b, _join(fpre, "depth_head"), _join(tpre, "depth_head", sep="."))


def fs_reduced(b: FlaxToTorch, fpre: str, tpre: str):
    """flax Conv3dNormActReduced → conv1.{0,1}, conv2.{0,1}."""
    for f, t in (("conv_sp", "conv1"), ("conv_d", "conv2")):
        b.conv(f"{fpre}/{f}", f"{tpre}.{t}.0")
        b.bn(f"{fpre}/{f}", f"{tpre}.{t}.1")


def fs_res3d(b: FlaxToTorch, fpre: str, tpre: str):
    """flax ResnetBasicBlock3D → conv1, bn1, conv2, bn2."""
    for i in (1, 2):
        b.conv(f"{fpre}/conv{i}", f"{tpre}.conv{i}")
        b.bn(f"{fpre}/conv{i}", f"{tpre}.bn{i}")


def disp_transformer(b: FlaxToTorch, fpre: str, tpre: str):
    """flax CostVolumeDisparityAttention → sa.i.{self_attn.*, linear1, linear2,
    norm1, norm2}; the layer count is read from the variables."""
    for i in range(_count(_subtree(b, fpre), lambda k: k.startswith("sa"))):
        fp, tp = f"{fpre}/sa{i}", f"{tpre}.sa.{i}"
        for f, t in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out_proj", "out_proj")):
            b.dense(f"{fp}/{f}", f"{tp}.self_attn.{t}")
        b.dense(f"{fp}/fc1", f"{tp}.linear1")
        b.dense(f"{fp}/fc2", f"{tp}.linear2")
        b.layer_norm(f"{fp}/norm1", f"{tp}.norm1")
        b.layer_norm(f"{fp}/norm2", f"{tp}.norm2")


def ahcf_hourglass(b: FlaxToTorch, fpre: str, tpre: str):
    """flax AHCFHourglass at fpre → the port's AHCFHourglass keys at tpre."""
    def conv_bn(f, t, deconv=False):
        b.conv(f"{fpre}/{f}", f"{tpre}.{t}.conv", deconv=deconv)
        b.bn(f"{fpre}/{f}", f"{tpre}.{t}.bn")

    for lvl in (1, 2, 3):
        conv_bn(f"conv{lvl}a", f"conv{lvl}.0")
        fs_reduced(b, f"{fpre}/conv{lvl}b", f"{tpre}.conv{lvl}.1")
    for name in ("conv3_up", "conv2_up", "conv1_up"):
        conv_bn(name, name, deconv=True)
    for f, t in (("agg0", "agg_0"), ("agg1", "agg_1")):
        conv_bn(f"{f}a", f"{t}.0")
        fs_reduced(b, f"{fpre}/{f}b", f"{tpre}.{t}.1")
        fs_reduced(b, f"{fpre}/{f}c", f"{tpre}.{t}.2")
    for f, t in HOURGLASS_ATTS:
        feature_att(b, f"{fpre}/{f}", f"{tpre}.{t}.feat_att")
    b.conv(f"{fpre}/conv_patch", f"{tpre}.conv_patch.0", raw=True)
    raw_bn(b, f"{fpre}/conv_patch_bn", f"{tpre}.conv_patch.1")
    disp_transformer(b, f"{fpre}/disp_att", f"{tpre}.atts.4")
    fs_reduced(b, f"{fpre}/out0", f"{tpre}.conv_out.0")
    fs_reduced(b, f"{fpre}/out1", f"{tpre}.conv_out.1")


def edgenext_plain(b: FlaxToTorch, fpre: str, tpre: str):
    """flax EdgeNextConvEncoderPlain → dwconv, pwconv1, pwconv2, gamma."""
    b.conv(f"{fpre}/dwconv", f"{tpre}.dwconv", raw=True)
    b.dense(f"{fpre}/pw1", f"{tpre}.pwconv1")
    b.dense(f"{fpre}/pw2", f"{tpre}.pwconv2")
    b.put(f"{tpre}.gamma", b.take("params", f"{fpre}/gamma"))


def selective_update_block(b: FlaxToTorch, ub: str = "gru_loop/update_block",
                           tb: str = "update_block"):
    """flax BasicSelectiveMultiUpdateBlock under the scanned loop → port keys;
    the GRU scales are read from the variables."""
    for k in ("convc1", "convc2", "convd1", "convd2", "conv"):
        b.conv(f"{ub}/encoder/{k}", f"{tb}.encoder.{k}", raw=True)
    for g in ("gru04", "gru08", "gru16"):
        if not b.has("params", f"{ub}/{g}"):
            continue
        b.conv(f"{ub}/{g}/conv0", f"{tb}.{g}.conv0.0", raw=True)
        b.conv(f"{ub}/{g}/conv1", f"{tb}.{g}.conv1.0", raw=True)
        for gru in ("small_gru", "large_gru"):
            for k in ("convz", "convr", "convq"):
                b.conv(f"{ub}/{g}/{gru}/{k}", f"{tb}.{g}.{gru}.{k}", raw=True)
    dh = f"{ub}/disp_head"
    b.conv(f"{dh}/conv_in", f"{tb}.disp_head.conv.0", raw=True)
    edgenext_plain(b, f"{dh}/enc0", f"{tb}.disp_head.conv.2")
    edgenext_plain(b, f"{dh}/enc1", f"{tb}.disp_head.conv.3")
    b.conv(f"{dh}/conv_out", f"{tb}.disp_head.conv.4", raw=True)
    b.conv(f"{ub}/mask0", f"{tb}.mask.0", raw=True)
    b.conv(f"{ub}/mask1", f"{tb}.mask.2", raw=True)


def fs_common(b: FlaxToTorch):
    """What FoundationStereo's and FastFoundationStereo's flax variables share
    besides the features' extras and the context net: the trunk and decoder,
    the stem, the superpixel heads, the volume's stem, hourglass and
    classifier, cam, sam and the update block."""
    edgenext(b, "feature/trunk", "feature")
    for name in ("deconv32_16", "deconv16_8", "deconv8_4"):
        f, t = f"feature/{name}", f"feature.{name}"
        b.conv(f"{f}/conv1/conv", f"{t}.conv1.conv", deconv=True)
        b.conv(f"{f}/fuse1", f"{t}.conv2.conv1")
        b.conv(f"{f}/fuse2", f"{t}.conv2.conv2")
    basic_conv(b, "stem_2a", "stem_2.0", bn=False)
    b.conv("stem_2b", "stem_2.1")
    conv2x(b, "spx_2_gru", "spx_2_gru", bn=False)
    b.conv("spx_gru", "spx_gru.0", deconv=True, raw=True)
    b.conv("proj_cmb", "proj_cmb", raw=True)
    b.conv("corr_stem0", "corr_stem.0", raw=True)
    basic_conv(b, "corr_stem1", "corr_stem.1")
    fs_res3d(b, "corr_stem2", "corr_stem.2")
    fs_res3d(b, "corr_stem3", "corr_stem.3")
    feature_att(b, "corr_feature_att", "corr_feature_att.feat_att")
    ahcf_hourglass(b, "cost_agg", "cost_agg")
    basic_conv(b, "classifier0", "classifier.0")
    fs_res3d(b, "classifier1", "classifier.1")
    b.conv("classifier2", "classifier.2", raw=True)
    b.conv("cam/fc1", "cam.fc.0", raw=True)
    b.conv("cam/fc2", "cam.fc.2", raw=True)
    b.conv("sam/samconv", "sam.samconv", raw=True)
    selective_update_block(b)


def foundationstereo_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax FoundationStereo {"params", "batch_stats"} → port state_dict (the
    reference's key names, as `torch_convert.convert_foundationstereo` reads
    them). Raises if a flax variable is left unconsumed."""
    b = FlaxToTorch(variables)
    fs_common(b)
    depth_anything(b, "feature/dino", "feature.dino.depth_anything")
    basic_conv(b, "feature/conv4a", "feature.conv4.0", bn=False)
    for f, t in (("conv4b", "1"), ("conv4c", "2")):
        for c in ("conv1", "conv2"):
            b.conv(f"feature/{f}/{c}", f"feature.conv4.{t}.{c}")
    multi_basic_encoder(b, "cnet", "cnet")
    b.conv("cnet/conv2", "cnet.conv2.conv")
    b.bn("cnet/conv2", "cnet.conv2.bn")
    return b.finish()


def fastfoundationstereo_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax FastFoundationStereo → port state_dict (as
    `torch_convert.convert_fastfoundationstereo` reads it). Raises if a flax
    variable is left unconsumed."""
    b = FlaxToTorch(variables)
    fs_common(b)
    b.conv("feature/conv4", "feature.conv4", raw=True)
    b.conv("cnet/conv04_net", "cnet.conv04.0", raw=True)
    b.conv("cnet/conv04_inp", "cnet.conv04.1", raw=True)
    return b.finish()


def mix_update_block(b: FlaxToTorch, ub: str, tb: str):
    """flax MixUpdateBlock at ub → the port's keys at tb: the twin motion
    encoder, the three GRUs, disp_head, mask_feat_4."""
    for k in ("convc1", "convc2", "convd1", "convd2", "conv"):
        for sfx in ("", "_mono"):
            b.conv(_join(ub, "encoder", k + sfx), _join(tb, "encoder", k + sfx, sep="."),
                   raw=True)
    update_block(b, ub=ub, tb=tb, encoder=False)


def monster_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax MonSter {"params", "batch_stats"}, drawn with the training heads,
    → port state_dict (the reference's key names, as
    `torch_convert.convert_monster` reads them). Raises if a flax variable
    is left unconsumed."""
    b = FlaxToTorch(variables)
    dino_vit(b, "mono/mono_encoder", "mono_encoder")
    dpt_head(b, "mono/mono_decoder", "mono_decoder")
    dpt_pyramid_decoder(b, "mono/feat_decoder", "feat_decoder")
    ft = "feat_transfer"
    for s in ("4", "8", "16", "32"):
        b.conv(f"{ft}/conv{s}x", f"{ft}.conv{s}x.0")
        if s != "4":
            b.conv(f"{ft}/up{s}", f"{ft}.conv_up_{s}x", deconv=True)
        if s != "32":
            b.conv(f"{ft}/res{s}x", f"{ft}.res_{s}x", raw=True)
            b.conv(f"feat_transfer_cnet/res_{s}x", f"feat_transfer_cnet.res_{s}x", raw=True)
    for s in ("stem_2", "stem_4", "stem_8", "stem_16", "spx_4"):
        basic_conv(b, f"{s}a", f"{s}.0", bn=False)
        b.conv(f"{s}b", f"{s}.1")
    conv2x(b, "spx_2", "spx_2", bn=False)
    b.conv("spx", "spx.0", deconv=True, raw=True)
    conv2x(b, "spx_2_gru", "spx_2_gru")
    b.conv("spx_gru", "spx_gru.0", deconv=True, raw=True)
    basic_conv(b, "conv", "conv", bn=False)
    b.conv("desc", "desc", raw=True)
    basic_conv(b, "corr_stem", "corr_stem")
    feature_att(b, "corr_feature_att", "corr_feature_att.feat_att")
    for f, t in HOURGLASS_CONVS + (("conv3_up", "conv3_up"), ("conv2_up", "conv2_up")):
        b.conv(f"cost_agg/{f}", f"cost_agg.{t}.conv", deconv=f.endswith("_up"))
        b.bn(f"cost_agg/{f}", f"cost_agg.{t}.bn")
    b.conv("cost_agg/conv1_up", "cost_agg.conv1_up.conv", deconv=True)
    for f, t in HOURGLASS_ATTS:
        feature_att(b, f"cost_agg/{f}", f"cost_agg.{t}.feat_att")
    b.conv("classifier", "classifier", raw=True)
    for i in range(3):
        b.conv(f"context_zqr{i}", f"context_zqr_convs.{i}", raw=True)
    update_block(b)
    for branch in ("stereo", "mono"):
        mix_update_block(b, f"gru_loop_mix/update_mix_{branch}", f"update_block_mix_{branch}")
    for t in ("conv1_mono", "conv1_stereo", "conv2_mono", "conv2_stereo"):
        b.convbn(f"REMP/{t}", f"REMP.{t}")
    b.conv("REMP/conv_start", "REMP.conv_start.conv")
    b.bn("REMP/conv_start", "REMP.conv_start.bn")
    for i in range(1, 5):
        b.conv(f"REMP/unet/conv{i}a", f"REMP.RefinementBlock.conv{i}a.conv")
        b.bn(f"REMP/unet/conv{i}a", f"REMP.RefinementBlock.conv{i}a.bn")
        for t in (f"deconv{i}a", f"conv{i}b", f"deconv{i}b"):
            fp, tp = f"REMP/unet/{t}", f"REMP.RefinementBlock.{t}"
            b.conv(f"{fp}/conv1", f"{tp}.conv1.conv", deconv=t.startswith("deconv"))
            b.bn(f"{fp}/conv1", f"{tp}.conv1.bn")
            b.conv(f"{fp}/conv2", f"{tp}.conv2.conv")
            b.bn(f"{fp}/conv2", f"{tp}.conv2.bn")
    for f, t in (("lfe1", "LFE.0"), ("lfe2", "LFE.2"), ("lmc1", "LMC.0"), ("lmc2", "LMC.1"),
                 ("lmc3", "LMC.3"), ("final_conv", "final_conv")):
        b.conv(f"REMP/{f}", f"REMP.{t}", raw=True)
    return b.finish()
