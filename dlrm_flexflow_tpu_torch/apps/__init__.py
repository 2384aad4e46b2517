"""Applications built on the port (counterparts of
``dlrm_flexflow_tpu/apps``): the reference's DLRM, AlexNet, ResNet-50,
Inception-v3, Candle-Uno and NMT."""

from .dlrm import DLRMConfig, build_dlrm
from .alexnet import build_alexnet
from .resnet import build_resnet
from .inception import build_inception
from .candle_uno import CandleConfig, build_candle_uno
from .nmt import NMTConfig, build_nmt

__all__ = ["DLRMConfig", "build_dlrm", "build_alexnet", "build_resnet",
           "build_inception", "CandleConfig", "build_candle_uno",
           "NMTConfig", "build_nmt"]
