"""HiFT-Net vocoder (NSF source + ISTFT head): the inference half of
flowmirror_hydravox_tpu/models/hift.py, non-causal and causal.

  - Conv stacks are `F.conv1d` / `F.conv_transpose1d` on the JAX weights,
    which are already in torch layout ((O, I, K), and (I, O, K) for the
    transposed convs).
  - The tiny n_fft=16 / hop=4 STFT pair: framed rfft with center=True
    reflect padding, and a windowed overlap-add inverse.
  - SineGen2 source: frame-rate phase cumsum with linear down/up
    interpolation, harmonic stack, voiced/unvoiced gating. Its two random
    draws come in as tensors (`rand_ini`, `noise`).
  - CausalHiFT (`inference_causal`, `decode_causal`): the same parameter
    tree with causal padding, and two fixed noise buffers in place of the
    draws (`causal_noise` makes torch ones of JAX's shapes).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import HiFTConfig
from ..params import source_down_strides
from ..utils.audio import hann_window
from .dit import conv1d, linear


def snake(x, alpha):
    """Snake activation, alpha_logscale=False."""
    a = alpha[None, :, None]
    return x + (1.0 / (a + 1e-9)) * torch.sin(a * x) ** 2


def _conv_same(p, x, dilation: int = 1):
    k = p["w"].shape[-1]
    pad = (k * dilation - dilation) // 2
    return F.conv1d(x, p["w"], p["b"], padding=pad, dilation=dilation)


def resblock(p, x, dilations):
    for c1, c2, a1, a2, d in zip(p["convs1"], p["convs2"], p["alpha1"], p["alpha2"], dilations):
        xt = _conv_same(c1, snake(x, a1), dilation=d)
        xt = _conv_same(c2, snake(xt, a2))
        x = xt + x
    return x


def conv_transpose1d(p, x, stride: int, padding: int):
    """torch ConvTranspose1d: out = (T-1)*stride - 2*padding + K.
    p['w']: (I, O, K); x: (B, I, T)."""
    return F.conv_transpose1d(x, p["w"], p["b"], stride=stride, padding=padding)


# ---------------------------------------------------------------------------
# tiny STFT / ISTFT (torch.stft/istft center=True semantics)


def _window(n_fft: int, device):
    return torch.from_numpy(hann_window(n_fft)).to(device)


def _stft_16(x, n_fft: int, hop: int):
    """x: (B, T) -> (real, imag) each (B, n_fft//2+1, T//hop + 1)."""
    x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop) * _window(n_fft, x.device)  # (B, frames, n_fft)
    spec = torch.fft.rfft(frames, dim=-1).transpose(1, 2)
    return spec.real, spec.imag


def _overlap_add(w, hop: int):
    """w: (B, TT, n_fft) frames -> (B, hop*(TT-1)+n_fft), out[hop*f + c] += w[f, c]."""
    b, tt, n_fft = w.shape
    r = n_fft // hop
    wr = w.reshape(b, tt, r, hop)
    rows = sum(F.pad(wr[:, :, a], (0, 0, a, r - 1 - a)) for a in range(r))  # (B, TT+r-1, hop)
    return rows.reshape(b, -1)


def _istft_16(real, imag, n_fft: int, hop: int):
    """torch.istft equivalent (center=True): windowed overlap-add with
    window-envelope normalisation, trimmed by n_fft//2 at both ends."""
    window = _window(n_fft, real.device)
    spec = torch.complex(real, imag).transpose(1, 2)  # (B, TT, F)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    y = _overlap_add(frames, hop)
    env = _overlap_add((window ** 2).expand(1, frames.shape[1], n_fft), hop)
    y = y / torch.clamp_min(env, 1e-11)
    return y[:, n_fft // 2: -(n_fft // 2)]


# ---------------------------------------------------------------------------
# NSF source (SineGen2)


def _interp_linear(x, out_len: int):
    """F.interpolate(mode='linear', align_corners=False) over the last axis,
    written out as the JAX package computes it."""
    t = x.shape[-1]
    scale = t / out_len
    pos = (torch.arange(out_len, device=x.device) + 0.5) * scale - 0.5
    lo = torch.clamp(torch.floor(pos).long(), 0, t - 1)
    hi = torch.clamp(lo + 1, 0, t - 1)
    w = torch.clamp(pos - lo, 0.0, 1.0).to(x.dtype)
    return x[..., lo] * (1 - w) + x[..., hi] * w


def sine_source(cfg: HiFTConfig, f0_up, rand_ini, noise):
    """f0_up (B, T_samples, 1) sample-rate F0; rand_ini (B, nh) uniform [0, 1);
    noise (B, T_samples, nh) standard normal. Returns (source (B, T, 1)
    summed later, uv)."""
    nh = cfg.nb_harmonics + 1
    harmonics = torch.arange(1, nh + 1, dtype=torch.float32, device=f0_up.device)
    fn = f0_up * harmonics[None, None, :]  # (B, T, nh)

    rad = torch.remainder(fn / cfg.sampling_rate, 1.0)
    rand_ini = rand_ini.clone()
    rand_ini[:, 0] = 0.0
    rad = rad.clone()
    rad[:, 0, :] += rand_ini

    t = f0_up.shape[1]
    up = cfg.upsample_scale
    rad_frame = _interp_linear(rad.transpose(1, 2), t // up)  # (B, nh, T/up)
    phase = torch.cumsum(rad_frame, dim=-1) * 2.0 * math.pi
    phase_up = _interp_linear(phase * up, t)  # (B, nh, T)
    sines = torch.sin(phase_up).transpose(1, 2)  # (B, T, nh)

    uv = (f0_up > cfg.nsf_voiced_threshold).to(torch.float32)  # (B, T, 1)
    sine_waves = sines * cfg.nsf_alpha
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    return sine_waves * uv + noise_amp * noise, uv


def predict_f0(params: dict, mel):
    """(B, 80, T_mel) -> (B, T_mel) non-negative F0."""
    x = mel
    for conv in params["f0_predictor"]["convs"]:
        x = F.elu(_conv_same(conv, x))
    return torch.abs(linear(params["f0_predictor"]["classifier"], x.transpose(1, 2))[..., 0])


# ---------------------------------------------------------------------------
# decode


def decode(params: dict, cfg: HiFTConfig, mel, source):
    """mel (B, 80, T_mel); source (B, 1, T_samples). Returns (B, T_samples)."""
    n_fft, hop = cfg.istft_n_fft, cfg.istft_hop_len
    s_real, s_imag = _stft_16(source[:, 0], n_fft, hop)
    s_stft = torch.cat([s_real, s_imag], dim=1)  # (B, n_fft+2, TT)

    x = _conv_same(params["conv_pre"], mel)
    n_up = len(cfg.upsample_rates)
    strides = source_down_strides(cfg)
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(n_up):
        u, k = cfg.upsample_rates[i], cfg.upsample_kernel_sizes[i]
        x = conv_transpose1d(params["ups"][i], F.leaky_relu(x, cfg.lrelu_slope), u, (k - u) // 2)
        if i == n_up - 1:
            x = torch.cat([x[:, :, 1:2], x], dim=2)  # reflection pad (1, 0)
        sd = params["source_downs"][i]
        if strides[i] == 1:
            si = conv1d(sd, s_stft)
        else:
            si = F.conv1d(s_stft, sd["w"], sd["b"], stride=strides[i], padding=strides[i] // 2)
        x = x + resblock(params["source_resblocks"][i], si, cfg.source_resblock_dilation_sizes[i])
        xs = None
        for j in range(nk):
            r = resblock(params["resblocks"][i * nk + j], x, cfg.resblock_dilation_sizes[j])
            xs = r if xs is None else xs + r
        x = xs / nk

    x = _conv_same(params["conv_post"], F.leaky_relu(x))  # default slope 0.01
    magnitude = torch.exp(torch.clamp(x[:, : n_fft // 2 + 1], max=math.log(1e2)))
    phase = torch.sin(x[:, n_fft // 2 + 1:])
    audio = _istft_16(magnitude * torch.cos(phase), magnitude * torch.sin(phase), n_fft, hop)
    return torch.clamp(audio, -cfg.audio_limit, cfg.audio_limit)


def vocode(params: dict, cfg: HiFTConfig, mel, noise):
    """mel (B, 80, T_mel) -> (waveform (B, T_mel * upsample_scale), the
    predicted F0 (B, T_mel)). `noise.vocoder(b, t, nh)` gives the NSF
    source's two draws. GAN training (train/gan.py) needs the F0 too."""
    f0 = predict_f0(params, mel)  # (B, T_mel)
    f0_up = torch.repeat_interleave(f0, cfg.upsample_scale, dim=-1)[..., None]
    rand_ini, src_noise = noise.vocoder(f0_up.shape[0], f0_up.shape[1], cfg.nb_harmonics + 1)
    s, _ = sine_source(cfg, f0_up, rand_ini, src_noise)
    sine_merge = torch.tanh(linear(params["m_source_linear"], s))  # (B, T, 1)
    return decode(params, cfg, mel, sine_merge.transpose(1, 2)), f0


def inference(params: dict, cfg: HiFTConfig, mel, noise):
    """mel (B, 80, T_mel) -> waveform (B, T_mel * upsample_scale)."""
    return vocode(params, cfg, mel, noise)[0]


# ---------------------------------------------------------------------------
# Causal HiFT (CosyVoice-3's CausalHiFTGenerator; JAX hift.py:327-519)
#
# The non-causal model's parameter tree: conv_pre becomes a right-lookahead
# conv, every other conv left-causal, the upsamples nearest-x + a left conv,
# the source downsamples strided with a left pad. `finalize=False` consumes
# the trailing lookahead as context and emits fewer samples; a grown prefix
# reproduces the earlier samples, because the noise is two fixed buffers
# (JAX draws them with jax.random at seeds 101 and 102, which torch cannot
# reproduce, so they come in as arguments) of which a call takes a prefix.


def _causal_pad_len(kernel: int, dilation: int = 1) -> int:
    return ((kernel * dilation - dilation) // 2) * 2 + (kernel + 1) % 2


def _conv_causal_left(p, x, dilation: int = 1):
    pad = _causal_pad_len(p["w"].shape[-1], dilation)
    return F.conv1d(F.pad(x, (pad, 0)), p["w"], p["b"], dilation=dilation)


def resblock_causal(p, x, dilations):
    for c1, c2, a1, a2, d in zip(p["convs1"], p["convs2"], p["alpha1"], p["alpha2"], dilations):
        xt = _conv_causal_left(c1, snake(x, a1), dilation=d)
        xt = _conv_causal_left(c2, snake(xt, a2))
        x = xt + x
    return x


def _upsample_causal(p, x, stride: int):
    """Nearest x stride, left pad k-1, a stride-1 conv. `ups` weights are
    stored in the ConvTranspose layout (I, O, K): swapped to (O, I, K)."""
    w = p["w"].transpose(0, 1)
    x = torch.repeat_interleave(x, stride, dim=-1)
    return F.conv1d(F.pad(x, (w.shape[-1] - 1, 0)), w, p["b"])


def _source_down_causal(sd, x, stride: int):
    """A strided conv with a left pad of stride-1."""
    if stride == 1:
        return conv1d(sd, x)
    return F.conv1d(F.pad(x, (stride - 1, 0)), sd["w"], sd["b"], stride=stride)


def f0_look_right(params: dict) -> int:
    """Right lookahead of the causal F0 predictor: its first conv's causal
    padding (the shared tree's k 3 -> 2)."""
    return _causal_pad_len(params["f0_predictor"]["convs"][0]["w"].shape[-1])


def conv_pre_look_right(params: dict) -> int:
    """Right lookahead of the causal conv_pre (the shared tree's k 7 -> 6)."""
    return _causal_pad_len(params["conv_pre"]["w"].shape[-1])


def predict_f0_causal(params: dict, cfg: HiFTConfig, mel, finalize: bool = True):
    """The first conv looks right (padded on the right when `finalize`),
    the rest are left-causal. (B, 80, T_mel) -> (B, T_mel or T_mel - look)."""
    convs = params["f0_predictor"]["convs"]
    x = F.pad(mel, (0, f0_look_right(params))) if finalize else mel
    x = F.elu(F.conv1d(x, convs[0]["w"], convs[0]["b"]))
    for conv in convs[1:]:
        x = F.elu(_conv_causal_left(conv, x))
    return torch.abs(linear(params["f0_predictor"]["classifier"], x.transpose(1, 2))[..., 0])


def causal_noise(cfg: HiFTConfig, device, seed: int = 0):
    """(rand_ini (1, nh), noise (1, 300 * 24000 // nh, nh)), uniform [0, 1)
    from a generator seeded with `seed` on `device`: torch buffers of the
    shapes of JAX's fixed ones (hift.py:422-424, :441, :452)."""
    nh = cfg.nb_harmonics + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    rand_ini = torch.rand((1, nh), generator=gen, device=device)
    return rand_ini, torch.rand((1, 300 * 24000 // nh, nh), generator=gen, device=device)


def sine_source_causal(cfg: HiFTConfig, f0_up, rand_ini, noise):
    """SineGen2 with causal=True: f0_up (B, T, 1); the fixed buffers
    `rand_ini` (1, nh) and `noise` (1, >= T, nh), of which the first T rows
    are used. Returns (source (B, T, nh), uv)."""
    b, t, _ = f0_up.shape
    nh = cfg.nb_harmonics + 1
    harmonics = torch.arange(1, nh + 1, dtype=torch.float32, device=f0_up.device)
    rad = torch.remainder(f0_up * harmonics[None, None, :] / cfg.sampling_rate, 1.0)
    rand_ini = rand_ini.clone()
    rand_ini[:, 0] = 0.0
    rad[:, 0, :] += rand_ini.expand(b, nh)

    up = cfg.upsample_scale
    rad_frame = _interp_linear(rad.transpose(1, 2), t // up)
    phase = torch.cumsum(rad_frame, dim=-1) * 2.0 * math.pi
    # the causal form upsamples the phase to nearest, not linearly
    phase_up = torch.repeat_interleave(phase * up, up, dim=-1)[:, :, :t]
    sines = torch.sin(phase_up).transpose(1, 2)

    uv = (f0_up > cfg.nsf_voiced_threshold).to(torch.float32)
    sine_waves = sines * cfg.nsf_alpha
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    return sine_waves * uv + noise_amp * noise[:, :t, :], uv


def decode_causal(params: dict, cfg: HiFTConfig, mel, source, finalize: bool = True):
    """CausalHiFTGenerator.decode: mel (B, 80, T_mel), source (B, 1, T).
    Without `finalize` the last conv_pre_look_right frames are context only,
    and the output is trimmed by up_prod * hop samples."""
    n_fft, hop = cfg.istft_n_fft, cfg.istft_hop_len
    pre_lr = conv_pre_look_right(params)
    up_prod = math.prod(cfg.upsample_rates)
    s_real, s_imag = _stft_16(source[:, 0], n_fft, hop)
    x = F.pad(mel, (0, pre_lr)) if finalize else mel
    x = F.conv1d(x, params["conv_pre"]["w"], params["conv_pre"]["b"])
    if not finalize:
        s_real = s_real[:, :, : -(up_prod * pre_lr)]
        s_imag = s_imag[:, :, : -(up_prod * pre_lr)]
    s_stft = torch.cat([s_real, s_imag], dim=1)

    strides = source_down_strides(cfg)
    n_up = len(cfg.upsample_rates)
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(n_up):
        x = _upsample_causal(params["ups"][i], F.leaky_relu(x, cfg.lrelu_slope),
                             cfg.upsample_rates[i])
        if i == n_up - 1:
            x = torch.cat([x[:, :, 1:2], x], dim=2)  # reflection pad (1, 0)
        si = _source_down_causal(params["source_downs"][i], s_stft, strides[i])
        si = resblock_causal(params["source_resblocks"][i], si,
                             cfg.source_resblock_dilation_sizes[i])
        x = x + si[:, :, : x.shape[2]]
        xs = None
        for j in range(nk):
            r = resblock_causal(params["resblocks"][i * nk + j], x, cfg.resblock_dilation_sizes[j])
            xs = r if xs is None else xs + r
        x = xs / nk

    x = _conv_causal_left(params["conv_post"], F.leaky_relu(x))  # default slope 0.01
    magnitude = torch.exp(torch.clamp(x[:, : n_fft // 2 + 1], max=math.log(1e2)))
    phase = torch.sin(x[:, n_fft // 2 + 1:])
    audio = _istft_16(magnitude * torch.cos(phase), magnitude * torch.sin(phase), n_fft, hop)
    if not finalize:
        audio = audio[:, : -(up_prod * hop)]
    return torch.clamp(audio, -cfg.audio_limit, cfg.audio_limit)


def inference_causal(params: dict, cfg: HiFTConfig, mel, rand_ini, noise,
                     finalize: bool = True):
    """CausalHiFTGenerator.inference: mel (B, 80, T_mel) -> wav, with the
    fixed buffers `rand_ini` and `noise` (`causal_noise`). Without
    `finalize`, f0_look_right + conv_pre_look_right trailing frames are
    lookahead context: (T_mel - both) x upsample_scale - up_prod x hop
    samples come out."""
    f0 = predict_f0_causal(params, cfg, mel, finalize)
    f0_up = torch.repeat_interleave(f0, cfg.upsample_scale, dim=-1)[..., None]
    s, _ = sine_source_causal(cfg, f0_up, rand_ini, noise)
    sine_merge = torch.tanh(linear(params["m_source_linear"], s))
    mel_in = mel if finalize else mel[:, :, : -f0_look_right(params)]
    return decode_causal(params, cfg, mel_in, sine_merge.transpose(1, 2), finalize)
