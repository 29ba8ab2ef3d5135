"""The depth videos' colormaps as 256-entry uint8 RGB tables, the port's
own data (no matplotlib at run time).

Made once with matplotlib 3.10.8, exactly as the JAX package builds its
tables at run time (``video_depth_anything_tpu/io/video.py``
``colorize_depth``)::

    lut = (np.asarray(matplotlib.colormaps[name](np.arange(256) / 255.0))[:, :3]
           * 255).astype(np.uint8)

for ``name`` ``"inferno"`` (``INFERNO``) and ``"Spectral"`` (``SPECTRAL``),
then written out row by row as hex, three bytes (R, G, B) an entry.
``tests/test_torch_video_io.py`` holds both tables to matplotlib's."""

from __future__ import annotations

import numpy as np

_INFERNO_HEX = (
    "00000300000400000601000701010901010b02010e02021003021204031404031605041806041b07051d08061f090621"
    "0a07230b07260d08280e082a0f092d10092f120a32130a34140b36160b39170b3b190b3e1a0b401c0c431d0c451f0c47"
    "200c4a220b4c240b4e260b50270b52290b542b0a562d0a582e0a5a300a5c32095d34095f3509603709613909623b0964"
    "3c09653e0966400966410967430a68450a69460a69480b6a4a0b6a4b0c6b4d0c6b4f0d6c500d6c520e6c530e6d550f6d"
    "570f6d58106d5a116d5b116e5d126e5f126e60136e62146e63146e65156e66156e68166e6a176e6b176e6d186e6e186e"
    "70196e72196d731a6d751b6d761b6d781c6d7a1c6d7b1d6c7d1d6c7e1e6c801f6b811f6b83206b85206a86216a88216a"
    "8922698b22698d23698e24689024689125679325679526669626669827659928649b28649c29639e2963a02a62a12b61"
    "a32b61a42c60a62c5fa72d5fa92e5eab2e5dac2f5cae305baf315bb1315ab23259b43358b53357b73456b83556ba3655"
    "bb3754bd3753be3852bf3951c13a50c23b4fc43c4ec53d4dc73e4cc83e4bc93f4acb4049cc4148cd4247cf4446d04544"
    "d14643d24742d44841d54940d64a3fd74b3ed94d3dda4e3bdb4f3adc5039dd5238de5337df5436e05634e25733e35832"
    "e45a31e55b30e65c2ee65e2de75f2ce8612be9622aea6428eb6527ec6726ed6825ed6a23ee6c22ef6d21f06f1ff0701e"
    "f1721df2741cf2751af37719f37918f47a16f57c15f57e14f68012f68111f78310f7850ef8870df8880cf88a0bf98c09"
    "f98e08f99008fa9107fa9306fa9506fa9706fb9906fb9b06fb9d06fb9e07fba007fba208fba40afba60bfba80dfbaa0e"
    "fbac10fbae12fbb014fbb116fbb318fbb51afbb71cfbb91efabb21fabd23fabf25fac128f9c32af9c52cf9c72ff8c931"
    "f8cb34f8cd37f7cf3af7d13cf6d33ff6d542f5d745f5d948f4db4bf4dc4ff3de52f3e056f3e259f2e45df2e660f1e864"
    "f1e968f1eb6cf1ed70f1ee74f1f079f1f27df2f381f2f485f3f689f4f78df5f891f6fa95f7fb99f9fc9dfafda0fcfea4"
)

_SPECTRAL_HEX = (
    "9e0142a00342a20543a40843a60a44a80c44aa0f45ad1145af1446b11646b31847b51b47b71d48ba2048bc2249be2449"
    "c0274ac2294ac42c4bc62e4bc9304ccb334ccd354dcf384dd13a4ed33c4ed53e4ed6404ed8424dd9444dda464cdb484c"
    "dc494bde4b4bdf4d4be04f4ae1514ae25349e45549e55648e65848e75a47e95c47ea5e46eb6046ec6145ed6345ef6544"
    "f06744f16943f26b43f46d43f46f44f47245f57446f57747f57948f67c4af67e4bf6814cf7834df7864ef7894ff88b51"
    "f88e52f89053f99354f99555fa9856fa9a58fa9d59fb9f5afba25bfba55cfca75efcaa5ffcac60fdae61fdb063fdb265"
    "fdb466fdb668fdb86afdba6bfdbc6dfdbe6efdc070fdc272fdc473fdc675fdc877fdca78fdcc7afdce7cfdd07dfdd27f"
    "fdd481fdd682fdd884fdda86fddc87fdde89fee08bfee18dfee28ffee391fee493fee695fee797fee899fee99bfeea9d"
    "feec9ffeeda1feeea3feefa5fef1a7fef2a9fef3abfef4adfef5affef7b1fef8b3fef9b5fefab7fefbb9fefdbbfefebd"
    "fefebefdfebcfcfebbfbfdb9fafdb8f9fcb6f8fcb5f7fcb3f6fbb2f5fbb0f4faaef3faadf2faabf1f9aaf0f9a8eff8a7"
    "eef8a5edf8a4ecf7a2ebf7a1eaf69fe9f69ee8f69ce7f59be6f599e6f598e3f498e1f398dff299dcf199daf09ad8ef9a"
    "d5ee9bd3ed9bd1ec9cceeb9cccea9dcae99dc7e89ec5e79ec3e69fc0e59fbee5a0bce4a0bae3a0b7e2a1b5e1a1b3e0a2"
    "b0dfa2aedea3acdda3a9dca4a6dba4a4daa4a1d9a49ed8a49cd7a499d6a496d5a494d4a491d2a48ed1a48bd0a489cfa4"
    "86cea483cda481cca47ecba47bcaa478c9a476c8a473c7a470c6a46ec5a46bc4a468c3a466c2a563bfa561bda65fbba7"
    "5db8a85bb6a959b4aa57b2ab55afac53adad51abae4fa8af4da6b04ba4b149a2b2479fb3459db4439bb54199b53f96b6"
    "3d94b73b92b8398fb9378dba358bbb3389bc3286bc3484bb3682ba3880b9397db83b7bb73d79b63e77b54075b44272b2"
    "4470b1456eb0476caf4969ae4b67ad4c65ac4e63ab5060aa515ea9535ca8555aa75757a65855a55a53a45c51a35e4fa2"
)


def _table(hex_rows: str) -> np.ndarray:
    lut = np.frombuffer(bytes.fromhex(hex_rows), dtype=np.uint8).reshape(256, 3)
    lut.flags.writeable = False
    return lut


INFERNO = _table("".join(_INFERNO_HEX))
SPECTRAL = _table("".join(_SPECTRAL_HEX))
