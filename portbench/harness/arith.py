"""The model's work, worked out from its shapes.

Multiply-accumulates (MACs) of one image through each network, layer by
layer, counted as the plain reference computes them (``torch.utils.
flop_counter``'s rule: a convolution is its output size times its filter
size, a transposed one its input size times its filter size, an FIR filter
a dense 2-D convolution of each channel): every convolution, linear layer
and attention product, and nothing elementwise.  A FLOP is 2 MACs.

``styled_convs`` also gives the shapes the per-kernel byte counts need:
the six up-sampling convolutions' blurs and the 13 styled convolutions.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Conv:
    """One synthesis convolution at one image: input [hin, win, cin],
    output [hout, wout, cout], a k x k filter; ``up``: stride-2 transposed."""
    name: str
    hin: int
    cin: int
    cout: int
    k: int
    up: bool

    @property
    def hout(self) -> int:
        return 2 * self.hin if self.up else self.hin

    @property
    def macs(self) -> int:
        return self.hin ** 2 * self.cin * self.cout * self.k ** 2

    @property
    def t_out(self) -> int:
        """Side of the transposed conv's output, the blur's input."""
        return 2 * (self.hin - 1) + self.k


def channels(m: dict) -> dict:
    cm, cap = m["channel_multiplier"], m.get("max_channels", 512)
    raw = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm,
           256: 64 * cm, 512: 32 * cm, 1024: 16 * cm}
    return {k: min(v, cap) for k, v in raw.items()}


def styled_convs(m: dict) -> list:
    """The 13 styled convolutions (at 256px), in order."""
    ch = channels(m)
    out = [Conv("conv1", 4, m["param_dim"], ch[4], 3, False)]
    c_in = ch[4]
    for i in range(3, int(math.log2(m["size"])) + 1):
        r = 2 ** i
        out.append(Conv(f"up{r}", r // 2, c_in, ch[r], 3, True))
        out.append(Conv(f"conv{r}", r, ch[r], ch[r], 3, False))
        c_in = ch[r]
    return out


def fir(side_out: int, c: int) -> int:
    """A 4x4 FIR filter over ``c`` channels, ``side_out`` squared outputs."""
    return side_out ** 2 * c * 16


def mapping_macs(m: dict) -> int:
    return m["n_tokens"] * (m["style_dim"] ** 2 + m["param_dim"] ** 2)


def interaction_macs(m: dict) -> int:
    nt, sd, pd = m["n_tokens"], m["style_dim"], m["param_dim"]
    planes = sd // 4
    total = 0
    for i in range(m["n_trans"]):
        kv = sd + (nt if i == 0 else 0)
        q = pd + (nt if i == 0 else 0)
        total += nt * planes * (q + 2 * kv)           # q, k, v projections
        total += 2 * nt * nt * planes                 # logits, sim @ v
        total += nt * planes * sd                     # output projection
        total += 2 * nt * sd * sd                     # MLP
        if kv != sd:
            total += nt * kv * sd                     # block 0's skip
    return total + sd * nt * (2 * (int(math.log2(m["size"])) - 1))


def synthesis_macs(m: dict) -> int:
    sd = m["style_dim"]
    total = 0
    for c in styled_convs(m):
        total += sd * c.cin + c.macs                  # modulation, conv
        if c.up:
            total += fir(c.hout, c.cout)              # the blur
    ch = channels(m)
    for i in range(2, int(math.log2(m["size"])) + 1):
        r = 2 ** i
        total += sd * ch[r] + r * r * ch[r] * 3       # to_rgb
        if i > 2:
            total += fir(r, 3)                        # skip upsample
    return total


def generator_macs(m: dict, mapped: bool = True) -> int:
    """One image: mapping (unless the codes are given in plus space), the
    interaction and the synthesis."""
    return ((mapping_macs(m) if mapped else 0) + interaction_macs(m)
            + synthesis_macs(m))


def discriminator_convs(m: dict) -> list:
    """(name, macs) of one image through the discriminator."""
    ch = channels(m)
    size = m["size"]
    out = [("from_rgb", size * size * 3 * ch[size])]
    c_in, h = ch[size], size
    for i in range(int(math.log2(size)), 2, -1):
        c = ch[2 ** (i - 1)]
        out += [(f"res{h}.conv1", h * h * c_in * c_in * 9),
                (f"res{h}.blur", fir(h + 1, c_in)),
                (f"res{h}.conv2", (h // 2) ** 2 * c_in * c * 9),
                (f"res{h}.skip_blur", fir(h - 1, c_in)),
                (f"res{h}.skip", (h // 2) ** 2 * c_in * c)]
        c_in, h = c, h // 2
    out += [("final_conv", 16 * (c_in + 1) * ch[4] * 9),
            ("final_linear", ch[4] * 16 * ch[4] + ch[4])]
    return out


def discriminator_macs(m: dict) -> int:
    return sum(v for _, v in discriminator_convs(m))


ITEMSIZE = {"bfloat16": 2, "float32": 4}


def blur_image_bytes(m: dict, dtype: str) -> int:
    """One blur application over the six up-convs for one image: each reads
    its [2h+1, 2h+1, C] input and writes its [2h, 2h, C] output once."""
    return sum((c.t_out ** 2 + c.hout ** 2) * c.cout
               for c in styled_convs(m) if c.up) * ITEMSIZE[dtype]
