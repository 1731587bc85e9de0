"""The harness behind its family modules reads what it read before them,
when the Mistral trunk was written into ``lib/``: every value below is a
literal that the functions of that commit gave (``lib/counts.py``,
``lib/cell.py:port_config``, ``lib/weights.py``, ``reference/model.py``),
and each is compared to the last bit. The reference's readings are taken
on one CPU thread, where the sums' order is fixed."""

import dataclasses
import hashlib
import json

import pytest
import torch

from perfbench.lib import cell as cell_lib, counts, spec, weights
from perfbench.tests.helpers import SEED, TINY, tiny_cell

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]

COUNTS = {
    "mistral-train-32k": (719088657629184.0, 0.2668259289483519,
                          0.003365562154029851),
    "mistral-train-4k": (244095607898112.0, 0.016680182961051566,
                         0.0016828324298507464),
    "mixtral-train-4k": (93706254286848.0, 0.0033360365922103135,
                         0.0004006743880597015),
}

PORT_CONFIGS = {
    "mistral-7b-v0.3-l10": {
        "capacity_factor": 1.25, "d_ff": 14336, "d_model": 4096,
        "dtype": "bfloat16", "expert_top_k": 2, "head_dim": 128,
        "layer_scan_unroll": 1, "max_seq": 32768, "moe_balance_coef": 0.0,
        "moe_decode_mode": "auto", "moe_zloss_coef": 0.0, "n_experts": 0,
        "n_heads": 32, "n_kv_heads": 8, "n_layers": 10, "remat": True,
        "remat_policy": "full", "rope_theta": 1000000.0, "vocab_size": 32768,
    },
    "mixtral-8x7b-l2": {
        "capacity_factor": 1.25, "d_ff": 14336, "d_model": 4096,
        "dtype": "bfloat16", "expert_top_k": 2, "head_dim": 128,
        "layer_scan_unroll": 1, "max_seq": 32768, "moe_balance_coef": 0.02,
        "moe_decode_mode": "auto", "moe_zloss_coef": 0.0, "n_experts": 8,
        "n_heads": 32, "n_kv_heads": 8, "n_layers": 2, "remat": True,
        "remat_policy": "full", "rope_theta": 1000000.0, "vocab_size": 32000,
    },
}

# The last piece of each leaf: (layer, expert, sha256 of its fp32 bytes).
PIECES = {
    "mistral-7b-v0.3-l10": {
        "embed": (None, None,
        "8a0e2458cb3f69d52b6f4df7f573ed062f40ea9098cd2df93e2b607299caba55"),
        "final_norm": (None, None,
        "3035aac5fb87474c303702f9030301b4e6bb7aee93be3710b8ab8dcea201db70"),
        "layers.ln1": (9, None,
        "3035aac5fb87474c303702f9030301b4e6bb7aee93be3710b8ab8dcea201db70"),
        "layers.ln2": (9, None,
        "3035aac5fb87474c303702f9030301b4e6bb7aee93be3710b8ab8dcea201db70"),
        "layers.w_down": (9, None,
        "bacb617498e97a0968d36c14125b0dac6c5d652af422f53a6979cddf0e4bd1d1"),
        "layers.w_gate": (9, None,
        "b272ff1440db18ed6c75483d67ae8b3903013ee4bcba01019617323a7885e0bf"),
        "layers.w_up": (9, None,
        "a9924c6d2f4ba3b41bd569003022577a1cfdac14417958efebabf8272b603b3a"),
        "layers.wk": (9, None,
        "0636b4527cd76c58949124bb206c9556752b3ac8fb7e8c0bfdbae14ec05445c5"),
        "layers.wo": (9, None,
        "eb4dc592f437f029664b3f9f2c675950a5640ac15ab06b359f7373fbb2e8ce44"),
        "layers.wq": (9, None,
        "608cc9dac70e1fc1395fbb4975623ab6b1a787303558b6c3341070b49c0fde9a"),
        "layers.wv": (9, None,
        "73c7bfa893e72eae38d32e7caaf821f2003b7edacf52ceadbcd673b7be678546"),
        "unembed": (None, None,
        "4540df076a4f4931668b3cabf0488f4366ec92b7206fdc361e0179a84b5edb15"),
    },
    "mixtral-8x7b-l2": {
        "embed": (None, None,
        "7d8c13a76c69668468454a760e8611ae8f12a3100c7e093796b1d0115e9147ab"),
        "final_norm": (None, None,
        "3035aac5fb87474c303702f9030301b4e6bb7aee93be3710b8ab8dcea201db70"),
        "layers.ln1": (1, None,
        "3035aac5fb87474c303702f9030301b4e6bb7aee93be3710b8ab8dcea201db70"),
        "layers.ln2": (1, None,
        "3035aac5fb87474c303702f9030301b4e6bb7aee93be3710b8ab8dcea201db70"),
        "layers.router": (1, None,
        "52891cae6253d171ec46a775fec73634190f474ab6e873b0f386784cd62dc0c8"),
        "layers.w_down": (1, 7,
        "d5a8d32a18097af1e0a26c39c5ff054647554e18539cbfe17106a94237e8ea67"),
        "layers.w_gate": (1, 7,
        "154ba288fe910ffbcfbced08740c861a75deac47359625be2687bfe3120e59ab"),
        "layers.w_up": (1, 7,
        "9bd35a45b5a0f1756df9bdb516f4800998c2e1b87a82ff1b39ee780fa48950c9"),
        "layers.wk": (1, None,
        "d2f2676964316fbcd114aaa8063658a923fb2f3d4377f3d9684d16e3160388e0"),
        "layers.wo": (1, None,
        "925e7c6fcffd3a7423186f207ba5e5d06ba3a7618d83700aafb8fc7fae29c8ce"),
        "layers.wq": (1, None,
        "a5fe5e89fe3d36cfa9010bb4513367f5e27bbb8d5a601d89ce9d72eb1b1f95ed"),
        "layers.wv": (1, None,
        "b233ba5134db74a3907cd2ab13f8042b3646a1ed6ee4b07d48fcd2e29ab792d7"),
        "unembed": (None, None,
        "1c50c37233ae3f5e4fff2ac5619920817b1e9acc87d86482c2fe6917724082de"),
    },
}

TINY_TREES = {
    "tiny-dense-train": {
        "embed":
        "7eb070e91355165c27c8692573b1517934713f61db7b9394261a5e6f62191298",
        "final_norm":
        "2f20cd03c9cd392a406c56232b0ff93a15f6d6d7da79086bfa14f55d4a4031b0",
        "layers.ln1":
        "02722f124d0f1736a9dd7c4ddcd05630dcf16ee1ce3454e9a876005ce005d4ac",
        "layers.ln2":
        "02722f124d0f1736a9dd7c4ddcd05630dcf16ee1ce3454e9a876005ce005d4ac",
        "layers.w_down":
        "669e74102710d3f588fd3c4ccc13b7bbd3f71b104cfac8cedbf9afc95ec58762",
        "layers.w_gate":
        "cf0cb353867c1a4b8550d2a9c70eaf3a48aceb7627931717f83567e44854d64e",
        "layers.w_up":
        "697fb5a96374d23d8166c7f474d47343c2eaf367d1f4047a8ea4af16d560f981",
        "layers.wk":
        "44f6830b462b96be3b5e57c0b3668ded44cc6562c385886e7c06237c6a43b818",
        "layers.wo":
        "a3205c8a4a412b2b936152275e70ab29a512e413e1b88f9c318dbb2326bd0913",
        "layers.wq":
        "c1046c9dfced6de39fcdc2141bb2150727abd1963b710c311a377fe578b170c6",
        "layers.wv":
        "895e23ebbe99b0ffce49fa435c1557922595cb7b4c025af4f36b9707d508da43",
        "unembed":
        "ee4349fe29e89a5a4b1033b7c505cb9bec83410025d6a505483f408a5adfbad9",
    },
    "tiny-moe-train": {
        "embed":
        "7eb070e91355165c27c8692573b1517934713f61db7b9394261a5e6f62191298",
        "final_norm":
        "2f20cd03c9cd392a406c56232b0ff93a15f6d6d7da79086bfa14f55d4a4031b0",
        "layers.ln1":
        "02722f124d0f1736a9dd7c4ddcd05630dcf16ee1ce3454e9a876005ce005d4ac",
        "layers.ln2":
        "02722f124d0f1736a9dd7c4ddcd05630dcf16ee1ce3454e9a876005ce005d4ac",
        "layers.router":
        "42d149b8530e0d54be4cb7623da28c0fe99c6334816cfd92df4c5080973b7043",
        "layers.w_down":
        "821b79bb48d631ca212d734d86d5a245f8cb8daedbe55441d70f0e2347d9ab05",
        "layers.w_gate":
        "9fffb43bd63d9f12b98da702d932939c69ade464211896bacb5bc9f21fefa715",
        "layers.w_up":
        "314c7516e89067c3890867528531c56288789f64c13882d8584da1bd68ca7e72",
        "layers.wk":
        "44f6830b462b96be3b5e57c0b3668ded44cc6562c385886e7c06237c6a43b818",
        "layers.wo":
        "a3205c8a4a412b2b936152275e70ab29a512e413e1b88f9c318dbb2326bd0913",
        "layers.wq":
        "c1046c9dfced6de39fcdc2141bb2150727abd1963b710c311a377fe578b170c6",
        "layers.wv":
        "895e23ebbe99b0ffce49fa435c1557922595cb7b4c025af4f36b9707d508da43",
        "unembed":
        "ee4349fe29e89a5a4b1033b7c505cb9bec83410025d6a505483f408a5adfbad9",
    },
}

TINY_REFERENCE = {
    "tiny-dense-train": {
        "loss": [6.021481513977051, 6.137927532196045],
        "grad": {
            "embed": 0.08424022793769836,
            "final_norm": 0.10248667746782303,
            "layers.ln1": 0.061614058911800385,
            "layers.ln2": 0.06437131762504578,
            "layers.w_down": 0.40953806042671204,
            "layers.w_gate": 0.35458508133888245,
            "layers.w_up": 0.3299882709980011,
            "layers.wk": 0.22269918024539948,
            "layers.wo": 0.3476930558681488,
            "layers.wq": 0.22425733506679535,
            "layers.wv": 0.32325223088264465,
            "unembed": 0.4968371093273163,
        },
        "change": {
            "embed": 0.04239426925778389,
            "final_norm": 0.00490963039919734,
            "layers.ln1": 0.005320929456502199,
            "layers.ln2": 0.005274763330817223,
            "layers.w_down": 0.05111318454146385,
            "layers.w_gate": 0.05106780305504799,
            "layers.w_up": 0.05114417523145676,
            "layers.wk": 0.02925858460366726,
            "layers.wo": 0.04157470539212227,
            "layers.wq": 0.04186055064201355,
            "layers.wv": 0.02961776964366436,
            "unembed": 0.06080421805381775,
        },
    },
    "tiny-moe-train": {
        "loss": [6.069971561431885, 6.179967880249023],
        "grad": {
            "embed": 0.08819405734539032,
            "final_norm": 0.10873454809188843,
            "layers.ln1": 0.06087257340550423,
            "layers.ln2": 0.05476604402065277,
            "layers.router": 0.13829942047595978,
            "layers.w_down": 0.3514285683631897,
            "layers.w_gate": 0.2968399226665497,
            "layers.w_up": 0.29950326681137085,
            "layers.wk": 0.23311850428581238,
            "layers.wo": 0.36339712142944336,
            "layers.wq": 0.237947016954422,
            "layers.wv": 0.35959485173225403,
            "unembed": 0.5300187468528748,
        },
        "change": {
            "embed": 0.04257597401738167,
            "final_norm": 0.0049934471026062965,
            "layers.ln1": 0.005183499306440353,
            "layers.ln2": 0.005466836970299482,
            "layers.router": 0.01048953551799059,
            "layers.w_down": 0.10172796249389648,
            "layers.w_gate": 0.10183175653219223,
            "layers.w_up": 0.1018783375620842,
            "layers.wk": 0.029567096382379532,
            "layers.wo": 0.04149604216217995,
            "layers.wq": 0.0418705940246582,
            "layers.wv": 0.029347244650125504,
            "unembed": 0.06065171957015991,
        },
    },
}


def _sha(x: torch.Tensor) -> str:
    return hashlib.sha256(x.contiguous().numpy().tobytes()).hexdigest()


def _config(name: str) -> tuple:
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    config = json.loads((spec.ROOT / entry["file"]).read_text())
    fam = spec.family(config["model_type"])
    return fam, fam.shape(config)


@pytest.mark.parametrize("workload", sorted(COUNTS))
def test_the_counts_are_the_same(workload):
    cell = spec.load_cell(workload)
    s = cell.family.shape(cell.config)
    b, t = int(cell.traffic["batch"]), int(cell.traffic["seq"])
    assert (cell.family.model_flops(s, b, t),
            cell.family.attention_least_s(s, b, t, H100),
            cell.family.rms_norm_least_s(s, b, t, H100)) == COUNTS[workload]


@pytest.mark.parametrize("config", sorted(PORT_CONFIGS))
def test_the_port_config_is_the_same(config):
    from tony_tpu_torch.models import TransformerConfig

    fam, s = _config(config)
    got = fam.port_config(s)
    assert got == TransformerConfig(**PORT_CONFIGS[config])
    assert dataclasses.asdict(got) == PORT_CONFIGS[config]


@pytest.mark.parametrize("config", sorted(PIECES))
def test_a_piece_of_every_leaf_draws_the_same(config):
    fam, s = _config(config)
    got = {}
    for path, (shape, scale, _) in fam.leaf_table(s).items():
        (layer, expert), index = weights.pieces(path, s)[-1]
        piece = weights.fill_piece(torch.empty(shape[len(index):]), SEED,
                                   path, layer, expert, scale)
        got[path] = (layer, expert, _sha(piece))
        del piece
    assert got == PIECES[config]


@pytest.mark.parametrize("workload", TINY)
def test_the_tiny_trees_draw_the_same(workload):
    cell = tiny_cell(workload)
    s = cell.family.shape(cell.config)
    tree = weights.draw(s, SEED, "cpu")
    assert {p: _sha(x) for p, x in weights.leaf_items(tree)} == \
        TINY_TREES[workload]


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("workload", TINY)
def test_the_tiny_reference_reads_the_same(workload, one_thread):
    cell = tiny_cell(workload)
    s = cell.family.shape(cell.config)
    got = cell_lib.reference_readings(s, cell.traffic, 2, SEED,
                                      torch.device("cpu"))
    assert got == TINY_REFERENCE[workload]
