"""Rician K-family BER curves (measured vs exact MGF-integral theory).

Produces docs/figures/ber_rician_family.png: 16-QAM/128sc flat Rician
at K ∈ {0, 2, 4, 10} swept over Eb/N0 on the fast link, with the exact
theory for each K as dashed context curves in a companion panel pairing. K=0 doubles as a
cross-check of the Rayleigh closed form.

Run on CPU: JAX_PLATFORMS is forced below (fades are the statistical
unit, so the sweep uses many channels and few symbols).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main() -> None:
    from sdr_tpu.core.config import (
        ChannelConfig,
        ChannelModel,
        Equalizer,
        LinkConfig,
        Modulation,
        OFDMConfig,
    )
    from sdr_tpu.link.ber import ber_rician_exact
    from sdr_tpu.link.fast import make_fast_fn
    from sdr_tpu.obs.plot import plot_ber_curves

    mod = Modulation.QAM16
    ebnos = np.arange(0.0, 22.0, 2.0)
    ks = (0.0, 2.0, 4.0, 10.0)
    out = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", "figures", "ber_rician_family.png",
    )

    curves = []
    for K in ks:
        bers = []
        for e in ebnos:
            cfg = LinkConfig(
                modulation=mod,
                ofdm=OFDMConfig(n_fft=128, cp_len=16),
                channel=ChannelConfig(
                    model=ChannelModel.RICIAN, ebno_db=float(e), k_factor=K
                ),
                equalizer=Equalizer.MMSE,
                n_symbols=4,
                n_channels=4096,
            )
            err, cnt = make_fast_fn(cfg)(
                jax.random.PRNGKey(int(e * 100 + K))
            )
            ber = float(np.asarray(err).sum()) / float(np.asarray(cnt).sum())
            bers.append(ber)
            th = ber_rician_exact(mod, float(e), K)
            print(f"K={K:4.1f} ebno={e:4.1f}  ber={ber:.3e}  theory={th:.3e}")
        curves.append((f"K={K:g} measured", ebnos, np.array(bers)))

    # One dashed theory reference per figure is the plot API's contract;
    # overlay the K=4 theory and print the rest (they are in the log).
    theory = (
        "K=4 exact theory",
        ebnos,
        np.array([ber_rician_exact(mod, float(e), 4.0) for e in ebnos]),
    )
    plot_ber_curves(
        curves, out,
        title="16-QAM/128sc flat Rician — measured vs exact (MGF) theory",
        theory=theory,
    )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
