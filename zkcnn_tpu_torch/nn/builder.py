"""Model-to-circuit builder: gate emission + quantized inference witness.

Counterpart of `zkcnn_tpu/nn/builder.py`, the equivalent of the
reference's `neuralNetwork` (reference src/neuralNetwork.cpp:60-1016).
Field tensors live on the device given to `create`.  Differences from
the reference are in *how*, never in *what*:

  * gate loops become vectorized numpy index constructions (same
    emission order, so subset compaction yields identical layouts);
  * witness evaluation (the quantized CNN inference) runs in the INTEGER
    domain on the host: every non-FFT layer's values are small signed
    integers (gate constants are +-2^k with k <= Q_MAX, reference
    circuit.cpp:90-97), so an exact numpy int64 gate replay (object ints
    for the max-pool product trees, whose intermediates exceed 64 bits)
    reproduces calcNormalLayer (reference src/neuralNetwork.cpp:918-935)
    with no device work; one int->Montgomery conversion per layer
    materializes the prover's field tensors.  Only the field-valued
    FFT / DOT_PROD / IFFT layers run on the device (batched NTT +
    structural field matmul, reference calcFFTLayer / calcDotProdLayer,
    src/neuralNetwork.cpp:937-965); the integer conv result that the
    next layer reads is recomputed on the host (_host_conv_ints);
  * bit-decomposition witnesses (ReLU sign/magnitude bits, pooling
    remainders, max-pool gadgets; reference prepare* at
    src/neuralNetwork.cpp:899-916) are batched numpy bit extractions on
    the integer values.

The dynamic quantization pipeline (Q = 9, Q_BIT_SIZE = 220, x_bit /
w_bit / T bookkeeping) mirrors src/neuralNetwork.cpp:805-897,967-977
with identical double-precision arithmetic, so scale decisions agree
with the reference bit for bit on the same inputs.

The input witness layout matches src/neuralNetwork.cpp:687-689:
[image x pic_parallel | per-layer kernels & biases | aux bit witnesses
in layer order].
"""

import math
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..field import FR
from ..field.params import FR_P
from ..field.ops import SIGNED_FR
from ..circuit import Circuit, Layer, LayerType, ceil_pow2_bit_length
from ..circuit.ir import UNI_G, UNI_U, UNI_LU, UNI_SC, \
    BIN_G, BIN_U, BIN_V, BIN_SC, BIN_L
from ..circuit.eval import eval_dot_prod_layer, eval_fft_layer
from .params import ConvType, PoolType, ConvKernel, FconKernel, PoolKernel
from .source import TensorSource


def _tes(w, x, y, z, n, m, l):
    return ((w * n + x) * m + y) * l + z


def _tm_int(sc, qbs: int):
    """two_mul gate constants as integers: two_mul[k] = 2^k for
    k <= qbs, two_mul[qbs+1+j] = -2^j (reference src/circuit.cpp:90-97).
    Returns int64 when every exponent fits, else an object array."""
    sc = np.asarray(sc)
    neg = sc > qbs
    k = np.where(neg, sc - qbs - 1, sc).astype(np.int64)
    if k.size == 0 or int(k.max()) < 62:
        c = np.int64(1) << k
        return np.where(neg, -c, c)
    out = np.empty(sc.shape, object)
    fk, fn, fo = k.ravel(), neg.ravel(), out.ravel()
    for i in range(fo.size):
        v = 1 << int(fk[i])
        fo[i] = -v if fn[i] else v
    return out


def _scatter_add(out, g, vals):
    """Exact out[g] += vals.  int64 accumulators take the bincount fast
    path when every partial sum provably fits a float64 mantissa;
    object accumulators (arbitrary-precision) use np.add.at."""
    if vals.size == 0:
        return
    if out.dtype == object:
        np.add.at(out, g, vals)
        return
    mb = int(np.abs(vals).max())
    if mb == 0:
        return
    maxc = int(np.bincount(g, minlength=1).max())
    if mb * maxc < (1 << 52):
        acc = np.bincount(g, weights=vals.astype(np.float64),
                          minlength=out.size)
        out += acc.astype(np.int64)
    else:
        assert mb * maxc < (1 << 62), "int64 replay would overflow"
        np.add.at(out, g, vals)


def _stack_uni(g, u, lu, sc):
    """Broadcast columns to a common shape -> [N, 4] int64 gate block."""
    g, u, lu, sc = np.broadcast_arrays(
        np.asarray(g, np.int64), np.asarray(u, np.int64),
        np.asarray(lu, np.int64), np.asarray(sc, np.int64))
    return np.stack([g.ravel(), u.ravel(), lu.ravel(), sc.ravel()], axis=1)


def _stack_bin(g, u, v, sc, l):
    g, u, v, sc, l = np.broadcast_arrays(
        np.asarray(g, np.int64), np.asarray(u, np.int64),
        np.asarray(v, np.int64), np.asarray(sc, np.int64),
        np.asarray(l, np.int64))
    return np.stack([g.ravel(), u.ravel(), v.ravel(), sc.ravel(),
                     l.ravel()], axis=1)


class NeuralNetwork:
    """Builds the layered circuit + witness for a quantized CNN.

    Subclass/instantiate with conv_section / pool / full_conn filled
    (see models.py), then call create(source).
    """

    Q = 9
    Q_BIT_SIZE = 220

    NCONV_FAST_SIZE = 1
    NCONV_SIZE = 2
    FFT_SIZE = 5
    AVE_POOL_SIZE = 1
    FC_SIZE = 1
    RELU_SIZE = 1

    def __init__(self, psize_x, psize_y, pchannel, pparallel):
        self.pic_size_x = psize_x
        self.pic_size_y = psize_y
        self.pic_channel = pchannel
        self.pic_parallel = pparallel
        self.conv_section: List[List[ConvKernel]] = []
        self.pool: List[PoolKernel] = []
        self.full_conn: List[FconKernel] = []
        self.pool_ty = PoolType.NONE

    # ------------------------------------------------------------------
    # parameter bookkeeping (reference initParam, neuralNetwork.cpp:690-750)

    def _refresh_conv(self, new_nx, new_ny, conv: ConvKernel):
        self.nx_in, self.ny_in = new_nx, new_ny
        self.padding = conv.padding
        self.nx_padded_in = new_nx + 2 * conv.padding
        self.ny_padded_in = new_ny + 2 * conv.padding
        self.m = conv.size
        self.channel_in = conv.channel_in
        self.channel_out = conv.channel_out
        self.log_stride = conv.stride_bl
        self.nx_out = ((self.nx_padded_in - self.m) >> self.log_stride) + 1
        self.ny_out = ((self.ny_padded_in - self.m) >> self.log_stride) + 1
        self.new_nx_in = self.nx_out
        self.new_ny_in = self.ny_out
        self.conv_layer_cnt = (self.FFT_SIZE if conv.ty == ConvType.FFT
                               else self.NCONV_SIZE if conv.ty == ConvType.NAIVE
                               else self.NCONV_FAST_SIZE)

    def _refresh_fc(self, fc: FconKernel):
        self.nx_in = self.nx_out = self.m = 1
        self.ny_in = self.ny_out = 1
        self.channel_in = fc.channel_in
        self.channel_out = fc.channel_out

    def _fft_bit_len(self):
        return ceil_pow2_bit_length(self.nx_padded_in * self.ny_padded_in) + 1

    def _fft_len(self):
        return 1 << self._fft_bit_len()

    def _calc_size_after_pool(self, p: PoolKernel):
        self.pool_sz = p.size
        self.pool_bl = ceil_pow2_bit_length(p.size)
        self.pool_stride_bl = p.stride_bl
        self.pool_stride = 1 << p.stride_bl
        self.pool_layer_cnt = (1 + ceil_pow2_bit_length(p.size * p.size + 1)
                               if p.ty == PoolType.MAX else self.AVE_POOL_SIZE)
        self.new_nx_in = ((self.nx_out - self.pool_sz)
                          >> self.pool_stride_bl) + 1
        self.new_ny_in = ((self.ny_out - self.pool_sz)
                          >> self.pool_stride_bl) + 1

    def _pool_decmp_size(self):
        if self.pool_ty == PoolType.AVG:
            return (self.new_nx_in * self.new_ny_in * (self.pool_bl << 1)
                    * self.channel_out * self.pic_parallel)
        if self.pool_ty == PoolType.MAX:
            return (self.new_nx_in * self.new_ny_in * self.pool_sz ** 2
                    * self.channel_out * self.pic_parallel * (self.Q_MAX - 1))
        raise AssertionError("no pool")

    def _init_param(self):
        act_cnt = self.RELU_SIZE
        total_conv = total_pool = 0
        self.total_relu_in = self.total_ave_in = self.total_max_in = 0
        pos = (self.pic_size_x * self.pic_size_y * self.pic_channel
               * self.pic_parallel)
        self.new_nx_in, self.new_ny_in = self.pic_size_x, self.pic_size_y
        for i, sec in enumerate(self.conv_section):
            for conv in sec:
                self._refresh_conv(self.new_nx_in, self.new_ny_in, conv)
                conv.weight_start_id = pos
                pos += self.m ** 2 * self.channel_in * self.channel_out
                conv.bias_start_id = pos
                pos += self.channel_out
            total_conv += len(sec) * (self.conv_layer_cnt + act_cnt)
            if i >= len(self.pool):
                continue
            self._calc_size_after_pool(self.pool[i])
            total_pool += self.pool_layer_cnt
            if self.pool[i].ty == PoolType.MAX:
                total_conv -= act_cnt
        for fc in self.full_conn:
            self._refresh_fc(fc)
            fc.weight_start_id = pos
            pos += self.channel_out * self.channel_in
            fc.bias_start_id = pos
            pos += self.channel_out
        self.total_in_size = pos
        self.SIZE = (1 + total_conv + total_pool
                     + (self.FC_SIZE + self.RELU_SIZE) * len(self.full_conn))
        if self.full_conn:
            self.SIZE -= self.RELU_SIZE

    # ------------------------------------------------------------------
    # quantization (reference neuralNetwork.cpp:805-897,967-977)

    @staticmethod
    def _scale_bit(mx, mn, q):
        b = int(math.log(((1 << (q - 1)) - 1) / (mx - mn)) / math.log(2))
        if int((mx - mn) * math.pow(2.0, b)) > (1 << (q - 1)) - 1:
            b -= 1
        return b

    def _quantize(self, vals: np.ndarray, bit: int) -> np.ndarray:
        return np.trunc(vals * math.pow(2.0, bit)).astype(np.int64)

    def _get_next_bit(self, layer_id: int) -> int:
        """getNextBit (reference neuralNetwork.cpp:967-977).

        One deliberate divergence: the reference's `(int)log2(...)` cast
        truncates toward zero, which ROUNDS UP when the log is negative
        (large activations), making Q_MAX one bit too small and breaking
        the ReLU bit-reconstruction — a latent bug its bundled demo data
        never triggers.  floor() is identical on the reference's domain
        and correct in the corner (observed on lenetCifar with synthetic
        inputs: max|v| = 2^16.05 vs a Q_MAX budget of 2^16)."""
        v = self.ivals[layer_id]
        pos, neg = v[v > 0], v[v < 0]
        mx = int(pos.max()) if pos.size else 0
        mn = int(-neg.min()) if neg.size else 0
        x = mx + mn
        real_scale = x / math.pow(2.0, self.x_bit + self.w_bit)
        return math.floor(math.log2(((1 << (self.Q - 1)) - 1) / real_scale))

    # ------------------------------------------------------------------
    # val0 (input-layer witness) management

    def _val0_grow(self, need: int):
        if need > self.ival0_arr.size:
            cap = max(need, 2 * self.ival0_arr.size)
            arr = np.zeros(cap, np.int64)
            arr[: self.val0_len] = self.ival0_arr[: self.val0_len]
            self.ival0_arr = arr

    def _val0_append(self, seg) -> int:
        """Append an int64 segment; returns its start offset."""
        seg = np.asarray(seg, np.int64).ravel()
        off = self.val0_len
        self._val0_grow(off + seg.size)
        self.ival0_arr[off: off + seg.size] = seg
        self.val0_len += seg.size
        return off

    def _val0_reserve(self, k: int) -> int:
        off = self.val0_len
        self._val0_grow(off + k)
        self.val0_len += k
        return off

    def _val0_fill(self, off: int, seg):
        seg = np.asarray(seg, np.int64).ravel()
        self.ival0_arr[off: off + seg.size] = seg

    def _write_params(self, start: int, q: np.ndarray):
        self.ival0_arr[start: start + q.size] = q

    # ------------------------------------------------------------------
    # integer witness engine (exact host-side gate replay)

    def _int_replay(self, layer: Layer, lid: int) -> np.ndarray:
        """calcNormalLayer in the integer domain (reference
        src/neuralNetwork.cpp:918-935): exact numpy gate replay.  int64
        when products provably fit; object (python ints) otherwise
        (max-pool product trees).  Output length 2^bit_length."""
        qbs = self.Q_BIT_SIZE
        n_out = 1 << max(layer.bit_length, 0)
        v0 = self.ival0_arr
        prev = self.ivals[lid - 1] if lid > 1 else v0

        def amax(a):
            return int(np.abs(a).max()) if a.size else 0

        # gather each gate class and form its products, routing to
        # object (python-int) arithmetic per class only when the
        # products could overflow int64 (max-pool product trees)
        pending = []     # (g, vals) per class
        any_big = False
        uni, bi = layer.uni, layer.bin
        if uni.shape[0]:
            in_mask = uni[:, UNI_LU] == 0
            for msk, table in ((in_mask, v0), (~in_mask, prev)):
                sub = uni[msk]
                if not sub.shape[0]:
                    continue
                a = table[sub[:, UNI_U]]
                tm = _tm_int(sub[:, UNI_SC], qbs)
                if a.dtype != object and tm.dtype != object and \
                        amax(a) * amax(tm) >= (1 << 62):
                    a = a.astype(object)
                vals = a * tm
                any_big |= vals.dtype == object
                pending.append((sub[:, UNI_G], vals))
        if bi.shape[0]:
            u_in = bi[:, BIN_L] == 0
            v_in = (bi[:, BIN_L] & 1) == 0
            for mu, tu in ((u_in, v0), (~u_in, prev)):
                for mv, tv in ((v_in, v0), (~v_in, prev)):
                    sub = bi[mu & mv]
                    if not sub.shape[0]:
                        continue
                    a = tu[sub[:, BIN_U]]
                    b = tv[sub[:, BIN_V]]
                    tm = _tm_int(sub[:, BIN_SC], qbs)
                    if object not in (a.dtype, b.dtype, tm.dtype) and \
                            amax(a) * amax(b) * amax(tm) >= (1 << 62):
                        a = a.astype(object)
                    vals = a * b * tm
                    any_big |= vals.dtype == object
                    pending.append((sub[:, BIN_G], vals))

        out = np.zeros(n_out, object if any_big else np.int64)
        for g, vals in pending:
            if any_big and vals.dtype != object:
                vals = vals.astype(object)
            _scatter_add(out, g, vals)

        if layer.scale != 1:
            # the only scaled replayed layer is AVG_POOL with
            # scale = inv(k^2); the gadget guarantees exact division
            denom = pow(layer.scale, -1, FR_P)
            assert denom < (1 << 52), "unexpected layer scale"
            q, r = np.divmod(out, denom)
            assert not np.any(r != 0), "non-exact scale division"
            out = q
        return out

    def _int_eval(self, layer: Layer, lid: int):
        iv = self._int_replay(layer, lid)
        if iv.dtype == object and (iv.size == 0 or
                                   int(np.abs(iv).max()) < (1 << 62)):
            iv = iv.astype(np.int64)   # keep successors on the fast path
        self.ivals[lid] = iv
        self.vals[lid] = self._ival_to_dev(iv, layer.bit_length,
                                          self.device)

    @staticmethod
    def _ival_to_dev(ival: np.ndarray, bl: int, device):
        """Integer layer values -> padded [2^bl, 8] Montgomery tensor on
        `device`."""
        n = 1 << max(bl, 0)
        if ival.dtype == object:
            arr = np.zeros(n, object)
            arr[: ival.size] = ival
            return FR.from_bigint(arr, device)
        arr = np.zeros(n, np.int64)
        arr[: ival.size] = ival
        return FR.from_int64(arr, device)

    @staticmethod
    def _ints_from_dev(dev, count: int) -> np.ndarray:
        """Device Montgomery tensor -> signed int64 (exact for
        |v| < 2^63; used to read back the IFFT layer = the integer
        convolution results)."""
        neg, hi, lo = (x.cpu().numpy()
                       for x in SIGNED_FR.to_hilo(dev[:count]))
        v = (hi << np.int64(32)) | lo
        return np.where(neg, -v, v)

    def _padded_val0(self, C: Circuit):
        """val[0] padded to its hypercube."""
        v0 = self.val0()
        pad = (1 << C.layers[0].bit_length) - v0.shape[0]
        if pad:
            v0 = torch.cat([v0, FR.zeros(pad, self.device)])
        return v0

    def val0(self):
        return FR.from_int64(self.ival0_arr[: self.val0_len], self.device)

    # ------------------------------------------------------------------
    # reads (reference neuralNetwork.cpp:805-897)

    def _calc_input_layer(self):
        n = self.pic_channel * self.pic_size_x * self.pic_size_y
        dat = self.source.take(n)
        self.x_next_bit = self._scale_bit(dat.max(), dat.min(), self.Q)
        q = self._quantize(dat, self.x_next_bit)
        full = np.tile(q, self.pic_parallel)
        self.ival0_arr[:full.size] = full

    def _read_conv_weight(self, conv: ConvKernel):
        n = conv.channel_out * conv.channel_in * conv.size ** 2
        dat = self.source.take(n)
        self.w_bit = self._scale_bit(dat.max(), dat.min(), self.Q)
        self._write_params(conv.weight_start_id,
                           self._quantize(dat, self.w_bit))

    def _read_bias(self, bias_start: int, n: int):
        dat = self.source.take(n)
        self._write_params(bias_start,
                           self._quantize(dat, self.w_bit + self.x_bit))

    def _read_fcon_weight(self, fc: FconKernel):
        n = fc.channel_out * fc.channel_in
        dat = self.source.take(n)
        self.w_bit = self._scale_bit(dat.max(), dat.min(), self.Q)
        self._write_params(fc.weight_start_id, self._quantize(dat, self.w_bit))

    # ------------------------------------------------------------------
    # layer emitters

    def _padding_layer(self, layer: Layer, lid: int, first_conv_id: int):
        lenh = self._fft_len() >> 1
        pic, ci_n = self.pic_parallel, self.channel_in
        co_n = self.channel_out
        size = lenh * ci_n * (pic + co_n)
        layer.set_size(size, LayerType.PADDING)
        layer.fft_bit_length = self._fft_bit_len()

        L = -self.padding
        Rx, Ry = self.nx_in + self.padding, self.ny_in + self.padding
        nyp = self.ny_padded_in
        xs = np.arange(L, Rx)
        ys = np.arange(L, Ry)
        P, CI, X, Y = np.meshgrid(np.arange(pic), np.arange(ci_n), xs, ys,
                                  indexing="ij")
        mask = (X >= 0) & (X < self.nx_in) & (Y >= 0) & (Y < self.ny_in)
        slot = P * ci_n + CI
        g = slot * lenh + (Rx - X - 1) * nyp + (Ry - Y - 1)
        u = (slot * self.nx_in + X) * self.ny_in + Y
        img = _stack_uni(g[mask], u[mask], lid - 1, 0)

        first = pic * ci_n * lenh
        CO, CI, X, Y = np.meshgrid(np.arange(co_n), np.arange(ci_n),
                                   np.arange(self.nx_padded_in),
                                   np.arange(self.ny_padded_in),
                                   indexing="ij")
        mask = (X < self.m) & (Y < self.m)
        g = first + (CO * ci_n + CI) * lenh + X * nyp + Y
        u = first_conv_id + ((CO * ci_n + CI) * self.m + X) * self.m + Y
        ker = _stack_uni(g[mask], u[mask], 0, 0)
        layer.uni = np.concatenate([img, ker])

    def _fft_layer(self, layer: Layer, lid: int):
        size = self._fft_len() * self.channel_in * (self.pic_parallel
                                                    + self.channel_out)
        layer.set_size(size, LayerType.FFT)
        layer.fft_bit_length = self._fft_bit_len()
        self.vals[lid] = eval_fft_layer(layer, self.vals[lid - 1])

    def _dot_prod_layer(self, layer: Layer, lid: int):
        size = self._fft_len() * self.channel_out * self.pic_parallel
        layer.set_size(size, LayerType.DOT_PROD)
        layer.need_phase2 = True
        layer.fft_bit_length = self._fft_bit_len()

        pic, co_n, ci_n = self.pic_parallel, self.channel_out, self.channel_in
        P, CO, CI = np.meshgrid(np.arange(pic), np.arange(co_n),
                                np.arange(ci_n), indexing="ij")
        g = P * co_n + CO
        u = P * ci_n + CI
        v = (pic + CO) * ci_n + CI
        layer.bin = _stack_bin(g, u, v, 0, 1)
        layer.dp_dims = (pic, co_n, ci_n)   # structural fast paths
        self.vals[lid] = eval_dot_prod_layer(layer, self.vals[lid - 1],
                                             pic, co_n, ci_n)

    def _ifft_layer(self, layer: Layer, lid: int):
        lenh = self._fft_len() >> 1
        size = lenh * self.channel_out * self.pic_parallel
        layer.set_size(size, LayerType.IFFT)
        layer.fft_bit_length = self._fft_bit_len()
        layer.scale = pow(1 << layer.fft_bit_length, FR_P - 2, FR_P)
        self.vals[lid] = eval_fft_layer(layer, self.vals[lid - 1])
        # the IFFT output IS the integer conv result.  The downstream
        # host replay only reads the valid strided conv positions (the
        # ADD_BIAS gather), so compute those in int64 on the host; read
        # the device tensor back only when int64 could overflow.
        iv = self._host_conv_ints(lid, size)
        if iv is None:
            iv = self._ints_from_dev(self.vals[lid], size)
        self.ivals[lid] = iv

    def _conv_read_positions(self):
        """IFFT-slot indices the ADD_BIAS layer gathers (the valid
        strided conv outputs; same index math as _add_bias_layer)."""
        lenh = self._fft_len() >> 1
        L = -self.padding
        Rx, Ry = self.nx_in + self.padding, self.ny_in + self.padding
        nyp = self.ny_padded_in
        st = 1 << self.log_stride
        xs = L + st * np.arange(self.nx_out)
        ys = L + st * np.arange(self.ny_out)
        pic, co_n = self.pic_parallel, self.channel_out
        P, CO, X, Y = np.meshgrid(np.arange(pic), np.arange(co_n), xs, ys,
                                  indexing="ij")
        return ((P * co_n + CO) * lenh + (Rx - X - 1) * nyp
                + (Ry - Y - 1)).ravel()

    def _host_conv_ints(self, lid: int, size: int):
        """Integer IFFT-layer values, computed as a direct strided int64
        convolution on the host (exact; windows im2col + einsum).  Only
        the ADD_BIAS-gathered positions are filled -- no other gate
        reads this layer's integers (the proof's field tensors come
        from the device NTT pipeline regardless).  Returns None when
        the product bound could overflow int64 (caller falls back to
        the exact device readback)."""
        pic, ci_n, co_n = self.pic_parallel, self.channel_in, \
            self.channel_out
        nx, ny, m, pad = self.nx_in, self.ny_in, self.m, self.padding
        st = 1 << self.log_stride
        src = self.ival0_arr if lid - 4 == 0 else self.ivals[lid - 4]
        try:
            img = np.asarray(src[: pic * ci_n * nx * ny],
                             np.int64).reshape(pic, ci_n, nx, ny)
        except OverflowError:
            return None           # object ints beyond int64: device path
        ws = self.cur_conv.weight_start_id
        w = np.asarray(self.ival0_arr[ws: ws + co_n * ci_n * m * m],
                       np.int64).reshape(co_n, ci_n, m, m)
        mi = int(np.abs(img).max()) if img.size else 0
        mw = int(np.abs(w).max()) if w.size else 0
        if mi * mw * m * m * ci_n >= (1 << 62):
            return None
        imgp = np.pad(img, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
        win = np.lib.stride_tricks.sliding_window_view(
            imgp, (m, m), axis=(2, 3))[:, :, ::st, ::st]
        # win: [pic, ci, nx_out, ny_out, m, m]
        out = np.einsum("pcxymn,ocmn->poxy", win, w)
        arr = np.zeros(size, np.int64)
        arr[self._conv_read_positions()] = out.ravel()
        return arr

    def _add_bias_layer(self, layer: Layer, lid: int, first_bias_id: int):
        size = (self.nx_out * self.ny_out * self.channel_out
                * self.pic_parallel)
        layer.set_size(size, LayerType.ADD_BIAS)
        lenh = self._fft_len() >> 1
        L = -self.padding
        Rx, Ry = self.nx_in + self.padding, self.ny_in + self.padding
        nyp = self.ny_padded_in
        st = 1 << self.log_stride
        xs = L + st * np.arange(self.nx_out)
        ys = L + st * np.arange(self.ny_out)
        pic, co_n = self.pic_parallel, self.channel_out
        P, CO, X, Y = np.meshgrid(np.arange(pic), np.arange(co_n), xs, ys,
                                  indexing="ij")
        u = (P * co_n + CO) * lenh + (Rx - X - 1) * nyp + (Ry - Y - 1)
        g = ((P * co_n + CO) * self.nx_out + (X - L) // st) * self.ny_out \
            + (Y - L) // st
        bias = _stack_uni(g, first_bias_id + CO, 0, 0)
        conv = _stack_uni(g, u, lid - 1, 0)
        # interleave (bias, conv) per iteration like the reference
        layer.uni = np.stack([bias, conv], axis=1).reshape(-1, 4)
        self._read_bias(first_bias_id, co_n)
        self._int_eval(layer, lid)

    def _naive_conv_fast(self, layer: Layer, lid: int, first_conv_id: int,
                         first_bias_id: int):
        size = (self.nx_out * self.ny_out * self.channel_out
                * self.pic_parallel)
        layer.set_size(size, LayerType.NCONV)
        layer.need_phase2 = True
        pic, co_n, ci_n, m = (self.pic_parallel, self.channel_out,
                              self.channel_in, self.m)
        L = -self.padding
        st = 1 << self.log_stride
        xs = L + st * np.arange(self.nx_out)
        ys = L + st * np.arange(self.ny_out)
        from . import native
        blk = native.emit_nconv_gates(pic, co_n, ci_n, self.nx_in,
                                      self.ny_in, m, self.padding,
                                      self.log_stride, first_conv_id,
                                      2 * int(lid > 1))
        if blk is not None:
            layer.bin = blk
        else:
            P, CO, CI, X, Y, DX, DY = np.meshgrid(
                np.arange(pic), np.arange(co_n), np.arange(ci_n), xs, ys,
                np.arange(m), np.arange(m), indexing="ij")
            TX, TY = X + DX, Y + DY
            mask = (TX >= 0) & (TX < self.nx_in) & (TY >= 0) \
                & (TY < self.ny_in)
            g = _tes(P, CO, (X - L) // st, (Y - L) // st,
                     co_n, self.nx_out, self.ny_out)
            u = _tes(P, CI, TX, TY, ci_n, self.nx_in, self.ny_in)
            v = first_conv_id + _tes(CO, CI, DX, DY, ci_n, m, m)
            layer.bin = _stack_bin(g[mask], u[mask], v[mask], 0,
                                   2 * int(lid > 1))
        if first_bias_id >= 0:
            P, CO, X, Y = np.meshgrid(np.arange(pic), np.arange(co_n), xs, ys,
                                      indexing="ij")
            g = _tes(P, CO, (X - L) // st, (Y - L) // st,
                     co_n, self.nx_out, self.ny_out)
            layer.uni = _stack_uni(g, first_bias_id + CO, 0, 0)
        self._read_conv_weight(self.cur_conv)
        if first_bias_id >= 0:
            self._read_bias(first_bias_id, co_n)
        self._int_eval(layer, lid)

    def _naive_conv_mul(self, layer: Layer, lid: int, first_conv_id: int):
        pic, co_n, ci_n, m = (self.pic_parallel, self.channel_out,
                              self.channel_in, self.m)
        L = -self.padding
        st = 1 << self.log_stride
        xs = L + st * np.arange(self.nx_out)
        ys = L + st * np.arange(self.ny_out)
        P, CO, CI, X, Y, DX, DY = np.meshgrid(
            np.arange(pic), np.arange(co_n), np.arange(ci_n), xs, ys,
            np.arange(m), np.arange(m), indexing="ij")
        TX, TY = X + DX, Y + DY
        mask = ((TX >= 0) & (TX < self.nx_in) & (TY >= 0)
                & (TY < self.ny_in)).ravel()
        u = _tes(P, CI, TX, TY, ci_n, self.nx_in, self.ny_in).ravel()[mask]
        v = (first_conv_id + _tes(CO, CI, DX, DY, ci_n, m, m)).ravel()[mask]
        g = np.arange(u.size)
        layer.bin = _stack_bin(g, u, v, 0, 2 * int(lid > 1))
        layer.set_size(int(u.size), LayerType.NCONV_MUL)
        layer.need_phase2 = True
        self._read_conv_weight(self.cur_conv)
        self._int_eval(layer, lid)

    def _naive_conv_add(self, layer: Layer, lid: int, first_bias_id: int):
        size = (self.nx_out * self.ny_out * self.channel_out
                * self.pic_parallel)
        layer.set_size(size, LayerType.NCONV_ADD)
        pic, co_n, ci_n, m = (self.pic_parallel, self.channel_out,
                              self.channel_in, self.m)
        L = -self.padding
        st = 1 << self.log_stride
        xs = L + st * np.arange(self.nx_out)
        ys = L + st * np.arange(self.ny_out)
        P, CO, CI, X, Y, DX, DY = np.meshgrid(
            np.arange(pic), np.arange(co_n), np.arange(ci_n), xs, ys,
            np.arange(m), np.arange(m), indexing="ij")
        TX, TY = X + DX, Y + DY
        mask = ((TX >= 0) & (TX < self.nx_in) & (TY >= 0)
                & (TY < self.ny_in)).ravel()
        g_all = _tes(P, CO, (X - L) // st, (Y - L) // st,
                     co_n, self.nx_out, self.ny_out).ravel()[mask]
        u = np.arange(g_all.size)
        conv_uni = _stack_uni(g_all, u, lid - 1, 0)
        blocks = [conv_uni]
        if first_bias_id >= 0:
            P, CO, X, Y = np.meshgrid(np.arange(pic), np.arange(co_n), xs, ys,
                                      indexing="ij")
            g = _tes(P, CO, (X - L) // st, (Y - L) // st,
                     co_n, self.nx_out, self.ny_out)
            blocks.insert(0, _stack_uni(g, first_bias_id + CO, 0, 0))
            self._read_bias(first_bias_id, co_n)
        layer.uni = np.concatenate(blocks)
        self._int_eval(layer, lid)

    # -- ReLU gadget (reference neuralNetwork.cpp:344-439) --------------

    @staticmethod
    def _bits_of_abs(v: np.ndarray, shifts) -> np.ndarray:
        """|v| bit planes: [len(v), len(shifts)] 0/1 int64 (reference
        prepareDecmpBit, src/neuralNetwork.cpp:905-911)."""
        a = np.abs(np.asarray(v, np.int64))
        return np.stack([(a >> s) & 1 for s in shifts], axis=1)

    def _relu_bits_aux(self, prev_ints: np.ndarray, block_len: int):
        """[sign, bits msb..lsb] per activation -> [block_len*Q_MAX]
        int64 0/1 (reference prepareSignBit/prepareDecmpBit)."""
        v = np.asarray(prev_ints[:block_len], np.int64)
        assert int(np.abs(v).max(initial=0)) < 1 << (self.Q_MAX - 1), \
            "activation exceeds Q_MAX bit budget"
        shifts = [self.Q_MAX - 1 - s for s in range(1, self.Q_MAX)]
        bits = self._bits_of_abs(v, shifts)                # [bl, Q_MAX-1]
        allb = np.concatenate([(v < 0).astype(np.int64)[:, None], bits],
                              axis=1)
        return allb.reshape(-1)

    def _relu_act_layer(self, layer: Layer, lid: int, block_len: int):
        Q, QM, QBS = self.Q, self.Q_MAX, self.Q_BIT_SIZE
        size = block_len * (2 + QM)
        layer.set_size(size, LayerType.RELU)
        layer.need_phase2 = True
        layer.zero_start_id = block_len

        first_dcmp = self.val0_len
        aux = self._relu_bits_aux(self.ivals[lid - 1], block_len)
        self._val0_append(aux)
        self.total_relu_in += block_len * QM

        gs = np.arange(block_len)
        sign_u = first_dcmp + gs * QM
        s = np.arange(1, Q)
        # block 1: relu output
        uni1 = _stack_uni(gs[:, None], sign_u[:, None] + s, 0, Q - 1 - s)
        bin1 = _stack_bin(gs[:, None], sign_u[:, None],
                          sign_u[:, None] + s, Q - s + QBS, 0)
        # block 2: reconstruction == 0
        g2 = block_len + gs
        uni2a = _stack_uni(g2, gs, lid - 1, QBS + 1)
        bin2 = _stack_bin(g2, gs, sign_u, 1, 2 * int(lid > 1))
        sm = np.arange(1, QM)
        uni2b = _stack_uni(g2[:, None], sign_u[:, None] + sm, 0, QM - sm - 1)
        # block 3: bit checks
        g3 = 2 * block_len + np.arange(block_len * QM)
        u3 = first_dcmp + np.arange(block_len * QM)
        bin3 = _stack_bin(g3, u3, u3, 0, 0)
        uni3 = _stack_uni(g3, u3, 0, QBS + 1)
        layer.uni = np.concatenate([uni1, uni2a, uni2b, uni3])
        layer.bin = np.concatenate([bin1, bin2, bin3])
        self._int_eval(layer, lid)

    # -- pooling ---------------------------------------------------------

    def _window_indices(self):
        """[tot_new, pool_sz^2] indices into the conv-output layout."""
        pic, co_n = self.pic_parallel, self.channel_out
        X0 = self.pool_stride * np.arange(self.new_nx_in)
        Y0 = self.pool_stride * np.arange(self.new_ny_in)
        P, CO, X, Y, TX, TY = np.meshgrid(
            np.arange(pic), np.arange(co_n), X0, Y0,
            np.arange(self.pool_sz), np.arange(self.pool_sz), indexing="ij")
        u = _tes(P, CO, X + TX, Y + TY, co_n, self.nx_out, self.ny_out)
        return u.reshape(-1, self.pool_sz ** 2)

    def _avg_pool_layer(self, layer: Layer, lid: int):
        pic, co_n = self.pic_parallel, self.channel_out
        tot_new = self.new_nx_in * self.new_ny_in * co_n * pic
        dpool_bl = self.pool_bl << 1
        zero_start = tot_new
        self.pool_ty = PoolType.AVG
        size = zero_start + self._pool_decmp_size()
        layer.set_size(size, LayerType.AVG_POOL)
        layer.scale = pow(self.pool_sz ** 2, FR_P - 2, FR_P)
        layer.zero_start_id = zero_start
        layer.need_phase2 = True

        first_gate_id = self.val0_len
        self.total_ave_in += zero_start * dpool_bl

        win = self._window_indices()                       # [tot_new, k^2]
        gs = np.arange(tot_new)
        uni_win = _stack_uni(gs[:, None], win, lid - 1, 0)
        rm = np.arange(dpool_bl)
        idx = gs[:, None] * dpool_bl + rm
        u = first_gate_id + idx
        uni_rm = _stack_uni(gs[:, None], u, 0, dpool_bl - rm + self.Q_BIT_SIZE)
        g_bit = zero_start + idx
        bin_chk = _stack_bin(g_bit, u, u, 0, 0)
        uni_chk = _stack_uni(g_bit, u, 0, self.Q_BIT_SIZE + 1)
        layer.uni = np.concatenate([uni_win, uni_rm, uni_chk])
        layer.bin = bin_chk

        # witness: remainder bits of each window sum, msb..lsb
        sums = np.asarray(self.ivals[lid - 1], np.int64)[win].sum(axis=1)
        shifts = [dpool_bl - 1 - r for r in range(dpool_bl)]
        self._val0_append(self._bits_of_abs(sums, shifts).reshape(-1))
        self._int_eval(layer, lid)

    def _max_pool_layers(self, C: Circuit, lid: int) -> int:
        """Multi-layer MAX-pool gadget (reference
        neuralNetwork.cpp:486-627).  Returns the next layer id."""
        pic, co_n = self.pic_parallel, self.channel_out
        QM, QBS, Q = self.Q_MAX, self.Q_BIT_SIZE, self.Q
        tot_new = self.new_nx_in * self.new_ny_in * co_n * pic
        psz2 = self.pool_sz ** 2
        self.pool_ty = PoolType.MAX

        dcmp_cnt = self._pool_decmp_size()
        first_dcmp = self._val0_reserve(dcmp_cnt)          # filled later
        self.total_max_in += dcmp_cnt

        win = self._window_indices()
        prev = np.asarray(self.ivals[lid - 1], np.int64)
        # ReLU is folded into MAX pool (reference prepareMax,
        # src/neuralNetwork.cpp:913-916): negatives clamp to 0
        maxv = np.maximum(prev[win], 0).max(axis=1)
        first_max = self._val0_append(maxv)
        self.total_max_in += tot_new

        shifts = [QM - 2 - j for j in range(QM - 1)]
        maxbits = self._bits_of_abs(maxv, shifts)
        first_max_dcmp = self._val0_append(maxbits.reshape(-1))
        self.total_max_in += tot_new * (QM - 1)

        # layer 0: (max - x_i) and max-reconstruction zero block
        layer = C.layers[lid]
        size0 = tot_new * psz2 + tot_new
        layer.set_size(size0, LayerType.MAX_POOL)
        layer.zero_start_id = tot_new * psz2
        i_max = np.arange(tot_new)
        g = (i_max[:, None] * psz2 + np.arange(psz2))
        u_max = first_max + i_max
        uni_a = _stack_uni(g, u_max[:, None], 0, 0)
        uni_b = _stack_uni(g, win, lid - 1, QBS + 1)
        sub_uni = np.stack([uni_a, uni_b], axis=1).reshape(-1, 4)
        g_new = layer.zero_start_id + i_max
        uni_rec_max = _stack_uni(g_new, first_max + i_max, 0, QBS + 1)
        j = np.arange(QM - 1)
        u_bits = first_max_dcmp + i_max[:, None] * (QM - 1) + j
        uni_rec_bits = _stack_uni(g_new[:, None], u_bits, 0, QM - 2 - j)
        layer.uni = np.concatenate([sub_uni, uni_rec_max, uni_rec_bits])
        self._int_eval(layer, lid)
        lid += 1

        # fill the (max - x) bit decompositions from layer-0 outputs
        minus_cnt = tot_new * psz2
        mb = self._bits_of_abs(self.ivals[lid - 1][:minus_cnt],
                               [QM - 2 - b for b in range(QM - 1)])
        self._val0_fill(first_dcmp, mb.reshape(-1))

        contain_max_ly, ksize = 1, psz2
        while not (ksize & 1):
            ksize >>= 1
            contain_max_ly += 1
        ksize = psz2

        for i in range(1, self.pool_layer_cnt):
            layer = C.layers[lid]
            last = i == self.pool_layer_cnt - 1
            half = (ksize + 1) >> 1
            size = tot_new * (half + (ksize if i == 1 else 0)) \
                + (tot_new * QM if last else 0) \
                + (tot_new * psz2 * (QM - 1) if last else 0)
            layer.set_size(size, LayerType.MAX_POOL)
            layer.need_phase2 = True
            unis, bins = [], []

            before_mul = 0
            if last:
                before_mul = tot_new
                gs = np.arange(tot_new)
                jj = np.arange(Q - 1)
                ub = first_max_dcmp + gs[:, None] * (QM - 1) + jj
                unis.append(_stack_uni(gs[:, None], ub, 0, Q - 2 - jj))

            cnt = np.arange(tot_new)
            for jpair in range((ksize + 1) >> 1):
                gg = before_mul + cnt * half + jpair
                uu = cnt * ksize + 2 * jpair
                if 2 * jpair + 1 < ksize:
                    vv = cnt * ksize + 2 * jpair + 1
                    bins.append(_stack_bin(gg, uu, vv, 0, int(lid > 1)))
                elif i == contain_max_ly:
                    bins.append(_stack_bin(gg, uu, first_max + cnt, 0,
                                           2 * int(lid > 1)))
                else:
                    unis.append(_stack_uni(gg, uu, lid - 1, 0))

            if i == 1:
                minus_new = tot_new * half
                layer.zero_start_id = minus_new
                v = np.arange(minus_cnt)
                gz = minus_new + v
                unis.append(_stack_uni(gz, v, lid - 1, QBS + 1))
                bj = np.arange(QM - 1)
                ub = first_dcmp + v[:, None] * (QM - 1) + bj
                unis.append(_stack_uni(gz[:, None], ub, 0, QM - 2 - bj))
            elif last:
                layer.zero_start_id = before_mul
                jjj = np.arange(minus_cnt)
                gz = before_mul + tot_new + jjj
                uz = first_dcmp + jjj
                bins.append(_stack_bin(gz, uz, uz, 0, 0))
                unis.append(_stack_uni(gz, uz, 0, QBS + 1))

            ksize = half
            layer.uni = np.concatenate(unis) if unis else layer.uni
            layer.bin = np.concatenate(bins) if bins else layer.bin
            self._int_eval(layer, lid)
            lid += 1
        return lid

    def _fully_conn_layer(self, layer: Layer, lid: int, fc: FconKernel):
        pic, co_n, ci_n = self.pic_parallel, self.channel_out, self.channel_in
        size = co_n * pic
        layer.set_size(size, LayerType.FCONN)
        layer.need_phase2 = True
        P, CO = np.meshgrid(np.arange(pic), np.arange(co_n), indexing="ij")
        g = P * co_n + CO
        layer.uni = _stack_uni(g, fc.bias_start_id + CO, 0, 0)
        P, CO, CI = np.meshgrid(np.arange(pic), np.arange(co_n),
                                np.arange(ci_n), indexing="ij")
        g = P * co_n + CO
        u = P * ci_n + CI
        v = fc.weight_start_id + CO * ci_n + CI
        layer.bin = _stack_bin(g, u, v, 0, 2 * int(lid > 1))
        self._read_fcon_weight(fc)
        self._read_bias(fc.bias_start_id, co_n)
        self._int_eval(layer, lid)

    # ------------------------------------------------------------------

    def create(self, source: TensorSource, only_compute: bool = False,
               device=None):
        """Reference neuralNetwork::create (src/neuralNetwork.cpp:60-142).
        Field tensors are built on `device`: the first CUDA device
        unless another is given."""
        assert len(self.pool) >= len(self.conv_section) - 1
        self.source = source
        self.device = resolve_device(device)
        self._init_param()
        C = Circuit.init(self.Q_BIT_SIZE, self.SIZE)
        self.C = C
        self.vals: List[Optional[torch.Tensor]] = [None] * self.SIZE
        self.ivals: List[Optional[np.ndarray]] = [None] * self.SIZE
        self.ival0_arr = np.zeros(max(2 * self.total_in_size, 1 << 16),
                                  np.int64)
        self.val0_len = self.total_in_size
        self.total_para_size = self.total_in_size - (
            self.pic_size_x * self.pic_size_y * self.pic_channel
            * self.pic_parallel)

        self._calc_input_layer()
        lid = 1
        self.new_nx_in, self.new_ny_in = self.pic_size_x, self.pic_size_y
        for i, sec in enumerate(self.conv_section):
            for j, conv in enumerate(sec):
                self.cur_conv = conv
                self._refresh_conv(self.new_nx_in, self.new_ny_in, conv)
                self.pool_ty = (self.pool[i].ty
                                if i < len(self.pool) and j == len(sec) - 1
                                else PoolType.NONE)
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
                    self._add_bias_layer(C.layers[lid], lid,
                                         conv.bias_start_id); lid += 1
                elif conv.ty == ConvType.NAIVE_FAST:
                    self._naive_conv_fast(C.layers[lid], lid,
                                          conv.weight_start_id,
                                          conv.bias_start_id); lid += 1
                else:
                    self._naive_conv_mul(C.layers[lid], lid,
                                         conv.weight_start_id); lid += 1
                    self._naive_conv_add(C.layers[lid], lid,
                                         conv.bias_start_id); lid += 1

                self.x_next_bit = self._get_next_bit(lid - 1)
                self.T = self.x_bit + self.w_bit - self.x_next_bit
                self.Q_MAX = self.Q + self.T
                if self.pool_ty != PoolType.MAX:
                    block_len = (self.nx_out * self.ny_out * self.channel_out
                                 * self.pic_parallel)
                    self._relu_act_layer(C.layers[lid], lid, block_len)
                    lid += 1

            if i >= len(self.pool):
                continue
            self._calc_size_after_pool(self.pool[i])
            if self.pool[i].ty == PoolType.AVG:
                self._avg_pool_layer(C.layers[lid], lid); lid += 1
            else:
                lid = self._max_pool_layers(C, lid)

        self.pool_ty = PoolType.NONE
        for i, fc in enumerate(self.full_conn):
            self._refresh_fc(fc)
            self.x_bit = self.x_next_bit
            self._fully_conn_layer(C.layers[lid], lid, fc); lid += 1
            if i == len(self.full_conn) - 1:
                break
            self.x_next_bit = self._get_next_bit(lid - 1)
            self.T = self.x_bit + self.w_bit - self.x_next_bit
            self.Q_MAX = self.Q + self.T
            self._relu_act_layer(C.layers[lid], lid,
                                 self.channel_out * self.pic_parallel)
            lid += 1

        assert self.SIZE == lid, (self.SIZE, lid)

        self.total_in_size = self.val0_len
        C.layers[0].set_size(self.total_in_size, LayerType.INPUT)

        # pad val[0] to its hypercube
        self.vals[0] = self._padded_val0(C)

        if not only_compute:
            C.init_subset()
        return C, self.vals

    def infer(self) -> np.ndarray:
        """argmax predictions per picture (reference printInfer,
        src/neuralNetwork.cpp:994-1016)."""
        n_class = self.full_conn[-1].channel_out
        v = np.asarray(self.ivals[self.SIZE - 1][: self.pic_parallel
                                                 * n_class], np.int64)
        v = v.reshape(self.pic_parallel, n_class)
        out = np.full(self.pic_parallel, -1)
        for p in range(self.pic_parallel):
            best, bv = -1, -1
            for c in range(n_class):
                if v[p, c] >= 0 and (best == -1 or int(v[p, c]) > bv):
                    best, bv = c, int(v[p, c])
            out[p] = best
        return out
