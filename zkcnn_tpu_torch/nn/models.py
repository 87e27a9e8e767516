"""Model zoo (counterpart of `zkcnn_tpu/nn/models.py`; reference
src/models.cpp:1-375, src/models.hpp:10-67).

Conv type auto-selection matches the reference: FFT convolution when
kernel > 3 or pic_parallel > 1, else the single-layer naive form
(reference src/models.cpp:21,50,105,153,172,194).
"""

from typing import List, Optional

import numpy as np

from .. import resolve_device
from .builder import NeuralNetwork
from .params import ConvType, PoolType, ConvKernel, FconKernel, PoolKernel


def _conv_ty(kernel_size: int, pparallel: int) -> ConvType:
    return ConvType.FFT if kernel_size > 3 or pparallel > 1 \
        else ConvType.NAIVE_FAST


class lenet(NeuralNetwork):
    """LeNet5: 2 x [5x5 conv -> pool] + FC 400-120-84-10
    (reference src/models.cpp:166-186)."""

    def __init__(self, psize_x, psize_y, pchannel, pparallel,
                 pool_ty: PoolType = PoolType.MAX):
        super().__init__(psize_x, psize_y, pchannel, pparallel)
        k = 5
        ty = _conv_ty(k, pparallel)
        pad = 2 if (psize_x == 28 and psize_y == 28) else 0
        self.conv_section.append([ConvKernel(ty, 6, pchannel, k, 0, pad)])
        self.pool.append(PoolKernel(pool_ty, 2, 1))
        self.conv_section.append([ConvKernel(ty, 16, 6, k, 0, 0)])
        self.pool.append(PoolKernel(pool_ty, 2, 1))
        self.full_conn = [FconKernel(120, 400), FconKernel(84, 120),
                          FconKernel(10, 84)]


class lenetCifar(NeuralNetwork):
    """3 conv sections variant (reference src/models.cpp:188-206)."""

    def __init__(self, psize_x, psize_y, pchannel, pparallel,
                 pool_ty: PoolType = PoolType.MAX):
        super().__init__(psize_x, psize_y, pchannel, pparallel)
        k = 5
        ty = _conv_ty(k, pparallel)
        self.conv_section.append([ConvKernel(ty, 6, pchannel, k, 0, 0)])
        self.pool.append(PoolKernel(pool_ty, 2, 1))
        self.conv_section.append([ConvKernel(ty, 16, 6, k, 0, 0)])
        self.pool.append(PoolKernel(pool_ty, 2, 1))
        self.conv_section.append([ConvKernel(ty, 120, 16, k, 0, 0)])
        self.full_conn = [FconKernel(84, 120), FconKernel(10, 84)]


class ccnn(NeuralNetwork):
    """Tiny test net: one 2x2 conv + pool, no FC
    (reference src/models.cpp:148-164)."""

    def __init__(self, psize_x, psize_y, pparallel, pchannel,
                 pool_ty: PoolType = PoolType.MAX):
        super().__init__(psize_x, psize_y, pchannel, pparallel)
        k = 2
        ty = _conv_ty(k, pparallel)
        self.conv_section.append([ConvKernel(ty, 2, pchannel, k, 0, 0)])
        self.pool.append(PoolKernel(pool_ty, 2, 1))


def _vgg_tail(self, new_nx, new_ny, last_ch):
    if self.pic_size_x == 224:
        self.full_conn = [FconKernel(4096, new_nx * new_ny * last_ch),
                          FconKernel(4096, 4096), FconKernel(1000, 4096)]
    else:
        assert self.pic_size_x == 32
        self.full_conn = [FconKernel(512, new_nx * new_ny * last_ch),
                          FconKernel(512, 512), FconKernel(10, 512)]


class vgg16(NeuralNetwork):
    """reference src/models.cpp:43-96."""

    def __init__(self, psize_x, psize_y, pchannel, pparallel,
                 pool_ty: PoolType = PoolType.MAX):
        super().__init__(psize_x, psize_y, pchannel, pparallel)
        start, k = 64, 3
        ty = _conv_ty(k, pparallel)
        plan = [[start, start], [start * 2, start * 2],
                [start * 4] * 3, [start * 8] * 3, [start * 8] * 3]
        ch_in = pchannel
        new_nx, new_ny = psize_x, psize_y
        for chans in plan:
            sec = []
            for ch in chans:
                sec.append(ConvKernel(ty, ch, ch_in, k))
                ch_in = ch
            self.conv_section.append(sec)
            self.pool.append(PoolKernel(pool_ty, 2, 1))
            new_nx = ((new_nx - 2) >> 1) + 1
            new_ny = ((new_ny - 2) >> 1) + 1
        _vgg_tail(self, new_nx, new_ny, start * 8)


class vgg11(NeuralNetwork):
    """reference src/models.cpp:98-146."""

    def __init__(self, psize_x, psize_y, pchannel, pparallel,
                 pool_ty: PoolType = PoolType.MAX):
        super().__init__(psize_x, psize_y, pchannel, pparallel)
        start, k = 64, 3
        ty = _conv_ty(k, pparallel)
        plan = [[start], [start * 2], [start * 4] * 2,
                [start * 8] * 2, [start * 8] * 2]
        ch_in = pchannel
        new_nx, new_ny = psize_x, psize_y
        for chans in plan:
            sec = []
            for ch in chans:
                sec.append(ConvKernel(ty, ch, ch_in, k))
                ch_in = ch
            self.conv_section.append(sec)
            self.pool.append(PoolKernel(pool_ty, 2, 1))
            new_nx = ((new_nx - 2) >> 1) + 1
            new_ny = ((new_ny - 2) >> 1) + 1
        _vgg_tail(self, new_nx, new_ny, start * 8)


class vgg(NeuralNetwork):
    """Config-driven VGG: channel counts with 'M'/'A' pool markers
    (reference src/models.cpp:12-41)."""

    def __init__(self, psize_x, psize_y, pchannel, pparallel,
                 config_tokens: List[str]):
        super().__init__(psize_x, psize_y, pchannel, pparallel)
        assert psize_x == psize_y
        k = 3
        ty = _conv_ty(k, pparallel)
        sections: List[List[ConvKernel]] = [[]]
        ch_in = pchannel
        new_nx, new_ny = psize_x, psize_y
        for tok in config_tokens:
            if tok[0] not in "MA":
                ch_out = int(tok)
                sections[-1].append(ConvKernel(ty, ch_out, ch_in, k))
                ch_in = ch_out
            else:
                sections.append([])
                p = PoolKernel(PoolType.MAX if tok[0] == "M" else PoolType.AVG,
                               2, 1)
                self.pool.append(p)
                new_nx = ((new_nx - p.size) >> p.stride_bl) + 1
                new_ny = ((new_ny - p.size) >> p.stride_bl) + 1
        self.conv_section = [s for s in sections if s]
        assert psize_x == 32
        self.full_conn = [FconKernel(512, new_nx * new_ny * ch_in),
                          FconKernel(512, 512), FconKernel(10, 512)]


class singleConv(NeuralNetwork):
    """Single-conv microbenchmark harness
    (reference src/models.cpp:208-375): conv pipeline only, no bias,
    no ReLU/pool, FFT path drops the ADD_BIAS layer."""

    def __init__(self, psize, pchannel, pparallel, kernel_size, channel_out,
                 ty: Optional[ConvType] = None):
        super().__init__(psize, psize, pchannel, pparallel)
        if ty is None:
            ty = _conv_ty(kernel_size, pparallel)
        self.conv_section.append(
            [ConvKernel(ty, channel_out, pchannel, kernel_size, 0,
                        kernel_size >> 1)])

    def _init_param(self):
        """initParamConv (reference src/models.cpp:260-286)."""
        conv_layer_cnt = 0
        pos = (self.pic_size_x * self.pic_size_y * self.pic_channel
               * self.pic_parallel)
        self.total_relu_in = self.total_ave_in = self.total_max_in = 0
        self.new_nx_in, self.new_ny_in = self.pic_size_x, self.pic_size_y
        for sec in self.conv_section:
            for conv in sec:
                self._refresh_conv(self.new_nx_in, self.new_ny_in, conv)
                conv_layer_cnt += (self.FFT_SIZE - 1
                                   if conv.ty == ConvType.FFT
                                   else self.NCONV_SIZE
                                   if conv.ty == ConvType.NAIVE
                                   else self.NCONV_FAST_SIZE)
                conv.weight_start_id = pos
                pos += self.m ** 2 * self.channel_in * self.channel_out
                conv.bias_start_id = -1
        self.total_in_size = pos
        self.SIZE = 1 + conv_layer_cnt

    def create(self, source, only_compute: bool = False, device=None):
        """createConv (reference src/models.cpp:208-258): conv stages
        only; FFT path has no ADD_BIAS."""
        self.source = source
        self.device = resolve_device(device)
        self._init_param()
        from ..circuit import Circuit
        C = Circuit.init(self.Q_BIT_SIZE, self.SIZE)
        self.C = C
        self.vals = [None] * self.SIZE
        self.ivals = [None] * self.SIZE
        self.ival0_arr = np.zeros(max(2 * self.total_in_size, 1 << 16),
                                  np.int64)
        self.val0_len = self.total_in_size

        self._calc_input_layer()
        lid = 1
        self.new_nx_in, self.new_ny_in = self.pic_size_x, self.pic_size_y
        self.pool_ty = PoolType.NONE
        for sec in self.conv_section:
            for conv in sec:
                self.cur_conv = conv
                self._refresh_conv(self.new_nx_in, self.new_ny_in, conv)
                self.x_bit = self.x_next_bit
                if conv.ty == ConvType.FFT:
                    self._padding_layer(C.layers[lid], lid,
                                        conv.weight_start_id)
                    self._read_conv_weight(conv)
                    self._int_eval(C.layers[lid], lid)
                    lid += 1
                    self._fft_layer(C.layers[lid], lid); lid += 1
                    self._dot_prod_layer(C.layers[lid], lid); lid += 1
                    self._ifft_layer(C.layers[lid], lid); lid += 1
                elif conv.ty == ConvType.NAIVE_FAST:
                    self._naive_conv_fast(C.layers[lid], lid,
                                          conv.weight_start_id, -1); lid += 1
                else:
                    self._naive_conv_mul(C.layers[lid], lid,
                                         conv.weight_start_id); lid += 1
                    self._naive_conv_add(C.layers[lid], lid, -1); lid += 1
        assert self.SIZE == lid

        self.total_in_size = self.val0_len
        from ..circuit import LayerType
        C.layers[0].set_size(self.total_in_size, LayerType.INPUT)
        self.vals[0] = self._padded_val0(C)
        if not only_compute:
            C.init_subset()
        return C, self.vals
