"""Token-space blocks of the AST and the New* models, counterparts of the
JAX package's ``models/blocks.py``: ``InputProjection`` (``:164``),
``OutputProjection`` (``:182``), ``Downsample`` (``:198``), ``Upsample``
(``:216``), ``Mlp`` (``:233``), ``LeFF`` (``:248``), ``FRFN`` (``:270``),
``make_token_mlp`` (``:300``), ``WindowAttentionSparse`` (``:310``), ``FDFP``
(``:379``) and ``MDASSA`` (``:408``), with the reference's parameter names
(``mlp.linear1.0.weight``, ``attn.qkv.to_q.weight`` in the AST,
``mdassa.attn.to_qkv.to_q.weight`` in the New* models, ...), so a reference
``state_dict`` loads as it is (``tools.convert.load_reference_state_dict``).

Activations are channels-last tokens (B, L, C) or images (B, H, W, C); the
convolutions see them as NCHW views with channels-last strides (``_image``).
A LeFF that follows a LayerNorm belongs to its block, which sends the two
together to ``ops.ln_leff`` (``operands()`` gives the weights in that
function's layout); the New* encoders' frequency LeFF has no LayerNorm and
runs here (``LeFF.forward``).

Kept quirks of the reference: ``Downsample`` and ``Upsample`` ignore an
output width (2C out, C/2 out); MDASSA builds its frequency window ratio and
never uses it, and the New* family never shifts its windows, so MDASSA here
takes no shift (the JAX module's shifted path is never exercised).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import (
    image_to_tokens,
    leaky_relu,
    tokens_to_image,
    window_attention,
    window_attention_plain,
    window_partition,
    window_reverse,
)
from ..ops.attention import merge_heads, split_heads
from ..ops.layers import Conv2d, Linear, TokenLayerNorm, gelu
from ..ops.wavelets import dwt2d, idwt2d
from ..ops.windows import relative_position_index
from ..parallel import cp_ops


def _image(x, cp=None):
    """Tokens (B, L, C) of a square map -> an NCHW view (channels-last
    strides); with ``cp`` the tokens are the rank's band of the map's rows
    (``parallel.cp_ops.band_shape``)."""
    h, w = cp_ops.band_shape(x.shape[1], cp)
    return tokens_to_image(x, h, w).permute(0, 3, 1, 2)


def _tokens(img):
    """NCHW -> contiguous tokens (B, L, C): free when the convolution wrote
    channels-last (it does for the channels-last views ``_image`` gives it),
    one copy at the NCHW input."""
    return image_to_tokens(img.permute(0, 2, 3, 1)).contiguous()


class InputProjection(nn.Module):
    """3x3 convs cin -> 8 -> 32 -> C, LeakyReLU(0.01), NCHW -> tokens."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.proj = nn.Sequential(*(
            Conv2d(a, b, 3, padding=1, device=device)
            for a, b in ((cin, 8), (8, 32), (32, cout))))

    def forward(self, x, cp=None):
        """NCHW (the rank's band of rows with ``cp``) -> tokens."""
        for conv in self.proj:
            x = cp_ops.conv(conv, x, cp)
        return _tokens(leaky_relu(x, 0.01))


class OutputProjection(nn.Module):
    """3x3 convs C -> 32 -> 8 -> cout, tokens -> NCHW."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.proj = nn.Sequential(*(
            Conv2d(a, b, 3, padding=1, device=device)
            for a, b in ((cin, 32), (32, 8), (8, cout))))

    def forward(self, x, cp=None):
        x = _image(x, cp)
        for conv in self.proj:
            x = cp_ops.conv(conv, x, cp)
        return x


class Downsample(nn.Module):
    """tokens -> 3x3 conv C -> C/2 (no bias) -> pixel_unshuffle(2): 2C
    channels at half the side."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.body = nn.Sequential(Conv2d(channels, channels // 2, 3,
                                         padding=1, bias=False,
                                         device=device))

    def forward(self, x, cp=None):
        """With ``cp`` the rank's band, of an even number of rows."""
        return _tokens(torch.nn.functional.pixel_unshuffle(
            cp_ops.conv(self.body[0], _image(x, cp), cp), 2))


class Upsample(nn.Module):
    """tokens -> 3x3 conv C -> 2C (no bias) -> pixel_shuffle(2): C/2
    channels at twice the side."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.body = nn.Sequential(Conv2d(channels, channels * 2, 3,
                                         padding=1, bias=False,
                                         device=device))

    def forward(self, x, cp=None):
        return _tokens(torch.nn.functional.pixel_shuffle(
            cp_ops.conv(self.body[0], _image(x, cp), cp), 2))


class Mlp(nn.Module):
    """fc1 -> gelu -> fc2 over tokens."""

    def __init__(self, dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim, device=device)
        self.fc2 = Linear(hidden_dim, dim, device=device)

    def forward(self, x, cp=None):
        return self.fc2(gelu(self.fc1(x)))


class LeFF(nn.Module):
    """Linear -> gelu -> depthwise 3x3 -> gelu -> Linear over square token
    maps; after a LayerNorm the block runs it through ``ops.ln_leff``."""

    def __init__(self, dim: int, hidden_dim: int, device=None):
        super().__init__()
        # Sequentials keep the reference's names (linear1.0.weight, ...)
        self.linear1 = nn.Sequential(Linear(dim, hidden_dim, device=device))
        self.dwconv = nn.Sequential(Conv2d(hidden_dim, hidden_dim, 3,
                                           padding=1, groups=hidden_dim,
                                           device=device))
        self.linear2 = nn.Sequential(Linear(hidden_dim, dim, device=device))

    def operands(self):
        """(w1 (C, hid), b1, taps (3, 3, hid), b_dw, w2 (hid, C), b2)."""
        fc1, dw, fc2 = self.linear1[0], self.dwconv[0], self.linear2[0]
        return (fc1.weight.t(), fc1.bias, dw.weight[:, 0].permute(1, 2, 0),
                dw.bias, fc2.weight.t(), fc2.bias)

    def forward(self, x, cp=None):
        y = gelu(self.linear1[0](x))
        y = _tokens(gelu(cp_ops.conv(self.dwconv[0], _image(y, cp), cp)))
        return self.linear2[0](y)


class FRFN(nn.Module):
    """A 3x3 conv over the first C/4 channels (no bias), Linear to 2 hid,
    gelu, split; the first half through depthwise 3x3 and gelu, times the
    second, Linear back to C."""

    def __init__(self, dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.dim_conv = dim // 4
        self.partial_conv3 = Conv2d(self.dim_conv, self.dim_conv, 3,
                                    padding=1, bias=False, device=device)
        self.linear1 = nn.Sequential(Linear(dim, 2 * hidden_dim,
                                            device=device))
        self.dwconv = nn.Sequential(Conv2d(hidden_dim, hidden_dim, 3,
                                           padding=1, groups=hidden_dim,
                                           device=device))
        self.linear2 = nn.Sequential(Linear(hidden_dim, dim, device=device))

    def forward(self, x, cp=None):
        img = _image(x, cp)
        img = torch.cat([cp_ops.conv(self.partial_conv3,
                                     img[:, :self.dim_conv], cp),
                         img[:, self.dim_conv:]], 1)
        y = gelu(self.linear1[0](_tokens(img)))
        y1, y2 = y.chunk(2, -1)
        y1 = _tokens(gelu(cp_ops.conv(self.dwconv[0], _image(y1, cp), cp)))
        return self.linear2[0](y1 * y2)


def make_token_mlp(kind: str, dim: int, hidden_dim: int, device=None):
    if kind == "leff":
        return LeFF(dim, hidden_dim, device=device)
    if kind == "frfn":
        return FRFN(dim, hidden_dim, device=device)
    if kind in ("ffn", "mlp"):
        return Mlp(dim, hidden_dim, device=device)
    raise ValueError(f"Unknown token_mlp type: {kind}")


class LinearProjection(nn.Module):
    """The AST's q and kv projections (``to_q``, ``to_kv`` from the tokens
    themselves)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.to_q = Linear(dim, dim, device=device)
        self.to_kv = Linear(dim, 2 * dim, device=device)


class QKVProjection(nn.Module):
    """MDASSA's q and kv projections: ``to_kv_from_q`` (C -> 2C) for the
    self-attention, ``to_kv`` (2C -> 2C, over concat(k, v) windows) for the
    cross-attention; the reference builds both in both and uses one
    (``load_reference_state_dict`` drops the other)."""

    def __init__(self, dim: int, cross: bool, device=None):
        super().__init__()
        self.to_q = Linear(dim, dim, device=device)
        if cross:
            self.to_kv = Linear(2 * dim, 2 * dim, device=device)
        else:
            self.to_kv_from_q = Linear(dim, 2 * dim, device=device)


class WindowAttentionSparse(nn.Module):
    """Attention inside windows of ``win_size``² tokens with a
    relative-position bias and, when ``sparse``, the softmax/relu² mix.
    x: (B * nW, N, C) -> (B * nW, N, C).  ``kv``: "ast" (the AST's
    ``qkv``, self-attention), "self" or "cross" (MDASSA's ``to_qkv``; the
    cross form takes k and v from ``attn_kv``, (B * nW, N, 2C))."""

    def __init__(self, dim: int, win_size: int, num_heads: int,
                 sparse: bool = True, kv: str = "ast", device=None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.kv = kv
        if kv == "ast":
            self.qkv = LinearProjection(dim, device=device)
        else:
            self.to_qkv = QKVProjection(dim, kv == "cross", device=device)
        self.proj = Linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * win_size - 1) ** 2, num_heads, device=device))
        self.w = (nn.Parameter(torch.ones(2, device=device)) if sparse
                  else None)
        # recomputed from win_size, so not saved (the reference's buffer is
        # dropped on load, tools.convert.load_reference_state_dict)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(win_size, win_size)).to(
                device), persistent=False)

    def bias(self):
        """(heads, N, N) f32 relative-position bias."""
        n = self.relative_position_index.shape[0]
        b = self.relative_position_bias_table[
            self.relative_position_index.view(-1)]
        return b.view(n, n, -1).permute(2, 0, 1)

    def forward(self, x, attn_kv=None, mask=None, use_kernels: bool = True):
        c = x.shape[-1]
        nh = self.num_heads
        if self.kv == "ast":
            q, kv = self.qkv.to_q(x), self.qkv.to_kv(x)
        elif attn_kv is None:
            q, kv = self.to_qkv.to_q(x), self.to_qkv.to_kv_from_q(x)
        else:
            q, kv = self.to_qkv.to_q(x), self.to_qkv.to_kv(attn_kv)
        q = split_heads(q, nh)
        k, v = split_heads(kv[..., :c], nh), split_heads(kv[..., c:], nh)
        attend = window_attention if use_kernels else window_attention_plain
        out = attend(q, k, v, self.bias(), scale=self.scale,
                     sparse_w=self.w, mask=mask)
        return self.proj(merge_heads(out))


class FDFP(nn.Module):
    """Frequency-domain feature projection over (B, H, W, C): DWT (Wavelet)
    or real(fft2) (Fourier), 1x1 conv C -> hidden, gelu, 1x1 conv back,
    then IDWT or real(ifft2); any other ``use_dwt`` skips the transforms,
    as the reference's string comparison does."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 use_dwt: str = "Fourier", device=None):
        super().__init__()
        self.use_dwt = use_dwt
        self.conv1 = Conv2d(in_channels, hidden_channels, 1, device=device)
        self.conv2 = Conv2d(hidden_channels, in_channels, 1, device=device)

    def forward(self, x, cp=None):
        """x (B, H, W, C), with ``cp`` the rank's band of rows (an even
        number): the DWT and the 1x1 convs are the band's own, the FFTs
        distributed (``cp_ops.fftn_real_spatial``), and the IDWT runs on
        the gathered map, whose backward (the reference's quirk) mixes
        rows across the whole map."""
        if self.use_dwt == "Wavelet":
            x = dwt2d(x)
        elif self.use_dwt == "Fourier":
            x = cp_ops.fftn_real_spatial(x, cp)
        y = self.conv2(gelu(self.conv1(x.permute(0, 3, 1, 2))))
        y = y.permute(0, 2, 3, 1)
        if self.use_dwt == "Wavelet":
            return cp_ops.slice_rows(idwt2d(cp_ops.gather_rows(y, cp)), cp)
        if self.use_dwt == "Fourier":
            return cp_ops.ifftn_real_spatial(y, cp)
        return y


class MDASSA(nn.Module):
    """The New* decoders' attention, tokens (B, L, C) -> (B, L, C):
    LayerNorm; window self-attention with its residual (the spatial
    branch); FDFP of the normed map as a frequency query, k and v from a
    1x1 conv of the spatial branch, window cross-attention, and the FDFP
    output as its residual.  No shift (the New* family never shifts)."""

    def __init__(self, dim: int, win_size: int, num_heads: int,
                 use_dwt: str = "Fourier", device=None):
        super().__init__()
        self.win_size = win_size
        self.norm1 = TokenLayerNorm(dim, device=device)
        self.attn = WindowAttentionSparse(dim, win_size, num_heads, kv="self",
                                          device=device)
        self.fdfp = FDFP(dim, 2 * dim, use_dwt, device=device)
        self.conv1x1 = Conv2d(dim, 2 * dim, 1, device=device)
        self.freq_attn = WindowAttentionSparse(dim, win_size, num_heads,
                                               kv="cross", device=device)

    def forward(self, x, use_kernels: bool = True, cp=None):
        """With ``cp`` the tokens are the rank's band of the map's rows (a
        multiple of the window), whose windows are its own."""
        b, l, c = x.shape
        h, w = cp_ops.band_shape(l, cp)
        ws, n = self.win_size, self.win_size ** 2
        x = self.norm1(x)
        img = tokens_to_image(x, h, w)
        wins = self.attn(window_partition(img, ws).reshape(-1, n, c),
                         use_kernels=use_kernels)
        spatial = x + image_to_tokens(
            window_reverse(wins.reshape(-1, ws, ws, c), ws, h, w))
        fq = self.fdfp(img, cp)
        kv = self.conv1x1(_image(spatial, cp)).permute(0, 2, 3, 1)
        kv_wins = torch.cat([window_partition(kv[..., :c], ws),
                             window_partition(kv[..., c:], ws)], -1)
        out = self.freq_attn(window_partition(fq, ws).reshape(-1, n, c),
                             attn_kv=kv_wins.reshape(-1, n, 2 * c),
                             use_kernels=use_kernels)
        out = fq + window_reverse(out.reshape(-1, ws, ws, c), ws, h, w)
        return image_to_tokens(out)
