"""Model registry: name -> (model class, layered default config).

The subset of ``recstudio_tpu/utils/registry.py`` this port implements:
SASRec, BERT4Rec, GRU4Rec, NARM, STAMP, DIN, DIEN, CL4SRec, CoSeRec,
ICLRec, Caser, FPMC, TransRec, HGN and NPE (``seq``, the whole family), BPR, PMF,
CML, NCF, LogisticMF, EASE, ItemKNN, SLIM, WRMF, IRGAN and DSSM (``mf``, the
whole family), IPSBPR and PDA (``debias``, the whole family), MultiDAE and
MultiVAE (``ae``), DeepFM,
FM, LR, WideDeep, DCN, NFM, AutoInt, InterHAt, DIFM, xDeepFM, DCNv2, PNN,
DLRM, FwFM, AFM, FFM, FmFM, FiBiNET, MaskNet, ONN, HFM, AFN, DeepCrossing,
FLEN, IFM, EDCN, FinalMLP, PPNet, DeepIM, LorentzFM, AOANet, SAM, DESTINE,
FiGNN, CCPM and FGCNN (``fm``, the whole family), LightGCN, NGCF, SimGCL, SGL
and NCL (``graph``, the whole family), HardShare, MMoE, PLE and AITM (``multitask``), and the
dataset configs they run on.
"""
from __future__ import annotations

import importlib
import os
from typing import Any, Dict, Tuple, Type

from .config import CONFIG_DIR, deep_update, get_base_model_config, load_json

# model name (lower case) -> (family, class name, config files layered over basemodel)
_MODELS = {"sasrec": ("seq", "SASRec", ("seq_all", "sasrec")),
           "bert4rec": ("seq", "BERT4Rec", ("seq_all", "bert4rec")),
           "gru4rec": ("seq", "GRU4Rec", ("seq_all", "gru4rec")),
           "narm": ("seq", "NARM", ("seq_all", "narm")),
           "stamp": ("seq", "STAMP", ("seq_all", "stamp")),
           "din": ("seq", "DIN", ("seq_all", "din")),
           "dien": ("seq", "DIEN", ("seq_all", "dien")),
           "cl4srec": ("seq", "CL4SRec", ("seq_all", "cl4srec")),
           "coserec": ("seq", "CoSeRec", ("seq_all", "coserec")),
           "iclrec": ("seq", "ICLRec", ("seq_all", "iclrec")),
           "caser": ("seq", "Caser", ("seq_all", "caser")),
           "fpmc": ("seq", "FPMC", ("seq_all", "fpmc")),
           "transrec": ("seq", "TransRec", ("seq_all", "transrec")),
           "hgn": ("seq", "HGN", ("seq_all", "hgn")),
           "npe": ("seq", "NPE", ("seq_all", "npe")),
           "bpr": ("mf", "BPR", ("mf_all", "bpr")),
           "pmf": ("mf", "PMF", ("mf_all", "pmf")),
           "cml": ("mf", "CML", ("mf_all", "cml")),
           "ncf": ("mf", "NCF", ("mf_all", "ncf")),
           "logisticmf": ("mf", "LogisticMF", ("mf_all", "logisticmf")),
           "ease": ("mf", "EASE", ("mf_all", "ease")),
           "itemknn": ("mf", "ItemKNN", ("mf_all", "itemknn")),
           "slim": ("mf", "SLIM", ("mf_all", "slim")),
           "wrmf": ("mf", "WRMF", ("mf_all", "wrmf")),
           "irgan": ("mf", "IRGAN", ("mf_all", "irgan")),
           "dssm": ("mf", "DSSM", ("mf_all", "dssm")),
           "ipsbpr": ("debias", "IPSBPR", ("ipsbpr",)),
           "pda": ("debias", "PDA", ("pda",)),
           "multidae": ("ae", "MultiDAE", ("multidae",)),
           "multivae": ("ae", "MultiVAE", ("multivae",)),
           "deepfm": ("fm", "DeepFM", ("fm_all", "deepfm")),
           "fm": ("fm", "FM", ("fm_all", "fm")),
           "lr": ("fm", "LR", ("fm_all", "lr")),
           "widedeep": ("fm", "WideDeep", ("fm_all", "widedeep")),
           "dcn": ("fm", "DCN", ("fm_all", "dcn")),
           "nfm": ("fm", "NFM", ("fm_all", "nfm")),
           "autoint": ("fm", "AutoInt", ("fm_all", "autoint")),
           "interhat": ("fm", "InterHAt", ("fm_all", "interhat")),
           "difm": ("fm", "DIFM", ("fm_all", "difm")),
           "xdeepfm": ("fm", "xDeepFM", ("fm_all", "xdeepfm")),
           "dcnv2": ("fm", "DCNv2", ("fm_all", "dcnv2")),
           "pnn": ("fm", "PNN", ("fm_all", "pnn")),
           "dlrm": ("fm", "DLRM", ("fm_all", "dlrm")),
           "fwfm": ("fm", "FwFM", ("fm_all", "fwfm")),
           "afm": ("fm", "AFM", ("fm_all", "afm")),
           "ffm": ("fm", "FFM", ("fm_all", "ffm")),
           "fmfm": ("fm", "FmFM", ("fm_all", "fmfm")),
           "fibinet": ("fm", "FiBiNET", ("fm_all", "fibinet")),
           "masknet": ("fm", "MaskNet", ("fm_all", "masknet")),
           "onn": ("fm", "ONN", ("fm_all", "onn")),
           "hfm": ("fm", "HFM", ("fm_all", "hfm")),
           "afn": ("fm", "AFN", ("fm_all", "afn")),
           "deepcrossing": ("fm", "DeepCrossing", ("fm_all", "deepcrossing")),
           "flen": ("fm", "FLEN", ("fm_all", "flen")),
           "ifm": ("fm", "IFM", ("fm_all", "ifm")),
           "edcn": ("fm", "EDCN", ("fm_all", "edcn")),
           "finalmlp": ("fm", "FinalMLP", ("fm_all", "finalmlp")),
           "ppnet": ("fm", "PPNet", ("fm_all", "ppnet")),
           "deepim": ("fm", "DeepIM", ("fm_all", "deepim")),
           "lorentzfm": ("fm", "LorentzFM", ("fm_all", "lorentzfm")),
           "aoanet": ("fm", "AOANet", ("fm_all", "aoanet")),
           "sam": ("fm", "SAM", ("fm_all", "sam")),
           "destine": ("fm", "DESTINE", ("fm_all", "destine")),
           "fignn": ("fm", "FiGNN", ("fm_all", "fignn")),
           "ccpm": ("fm", "CCPM", ("fm_all", "ccpm")),
           "fgcnn": ("fm", "FGCNN", ("fm_all", "fgcnn")),
           "lightgcn": ("graph", "LightGCN", ("lightgcn",)),
           "ngcf": ("graph", "NGCF", ("ngcf",)),
           "simgcl": ("graph", "SimGCL", ("simgcl",)),
           "sgl": ("graph", "SGL", ("sgl",)),
           "ncl": ("graph", "NCL", ("ncl",)),
           "hardshare": ("multitask", "HardShare", ("multitask_all", "hardshare")),
           "mmoe": ("multitask", "MMoE", ("multitask_all", "mmoe")),
           "ple": ("multitask", "PLE", ("multitask_all", "ple")),
           "aitm": ("multitask", "AITM", ("multitask_all", "aitm"))}


def list_models() -> Dict[str, str]:
    """Return {model_name_lower: family}."""
    return {name: family for name, (family, _, _) in _MODELS.items()}


def get_model(model_name: str) -> Tuple[Type, Dict[str, Any]]:
    """Look up a model class by name and assemble its layered default config."""
    lname = model_name.lower()
    if lname not in _MODELS:
        raise ValueError(f"Model '{model_name}' not found. Available: {sorted(_MODELS)}")
    family, class_name, layers = _MODELS[lname]
    module = importlib.import_module(f"recstudio_torch.models.{family}.{lname}")
    conf = get_base_model_config()
    for name in layers:
        conf = deep_update(conf, load_json(name))
    return getattr(module, class_name), conf


def get_dataset_default_config(dataset_name: str) -> Dict[str, Any]:
    """``data_all`` overlaid by ``<dataset>`` when the port ships one."""
    conf = load_json("data_all")
    if os.path.isfile(os.path.join(CONFIG_DIR, f"{dataset_name}.json")):
        conf = deep_update(conf, load_json(dataset_name))
    return conf
