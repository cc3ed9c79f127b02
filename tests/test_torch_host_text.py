"""The port's host-side text layer against the JAX package's: conversation
templates, `preprocess_sep1` / `preprocess_sep2` ids and labels, the image
and video spans, `keyword_stop_ids`, `Config` from a YAML file and from a
dict, and the registry's errors. Everything here is exact: the same
strings and the same int32 arrays from the toy tokenizer."""

import copy

import numpy as np
import pytest

from toy_tokenizer import ToyLlamaTokenizer
from ullava_tpu import config as jconfig
from ullava_tpu import conversation as jconv
from ullava_tpu import tokenization as jtok
from ullava_tpu.models import tools as jtools
from ullava_tpu_torch import config, constants, conversation, tokenization
from ullava_tpu_torch.models import tools
from ullava_tpu_torch.registry import Registry, registry

import ullava_tpu.constants as jconstants


def _sources():
    return [
        [{"from": "human", "value": "<image>\nWhat is in the picture ?"},
         {"from": "gpt", "value": "A brown dog ."},
         {"from": "human", "value": "Where is it ?"},
         {"from": "gpt", "value": "On the grass [SEG] ."}],
        [{"from": "gpt", "value": "skipped first turn"},
         {"from": "human", "value": "Describe it ."},
         {"from": "gpt", "value": "Brown and small ."}],
    ]


def test_constants_match_jax():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names == [n for n in dir(constants) if n.isupper()]
    for n in names:
        assert getattr(constants, n) == getattr(jconstants, n), n


@pytest.mark.parametrize("name", ["conv_simple", "conv_sep2", "conv_llama2"])
def test_conversation_templates_match_jax(name):
    turns = [("Describe <image> please.", "A dog."), ("And the colour?", ("Brown.", None, None)),
             ("Anything else?", None)]
    rendered = []
    for lib in (jconv.conversation_lib, conversation.conversation_lib):
        conv = lib[name].copy()
        for q, a in turns:
            conv.append_message(conv.roles[0], q)
            conv.append_message(conv.roles[1], a)
        rendered.append((conv.get_prompt(), conv.dict()["messages"], conv.sep_style.name))
    assert rendered[0] == rendered[1]
    assert conversation.default_conversation.version == jconv.default_conversation.version


def test_llama2_first_message_rules():
    conv = conversation.conversation_lib["conv_llama2"].copy()
    conv.append_message(conv.roles[1], "hi")
    with pytest.raises(ValueError):
        conv.get_prompt()


@pytest.mark.parametrize("conv_type", ["conv_simple", "conv_sep2", "conv_llama2"])
def test_preprocess_ids_and_labels_match_jax(conv_type):
    out = []
    for mod in (jtok, tokenization):
        tok = ToyLlamaTokenizer()
        srcs = copy.deepcopy(_sources())
        out.append(mod.preprocess(srcs, tok, conv_type))
    for key in ("input_ids", "labels"):
        assert len(out[0][key]) == len(out[1][key])
        for a, b in zip(out[0][key], out[1][key]):
            assert b.dtype == np.int32
            np.testing.assert_array_equal(b, a)
    assert any((lab != constants.IGNORE_INDEX).any() for lab in out[1]["labels"])


def test_preprocess_sep2_mismatch_guard_matches_jax():
    class BrokenTok(ToyLlamaTokenizer):
        def __call__(self, text, **kw):
            out = super().__call__(text, **kw)
            if "ASSISTANT" in text and "USER" in text and "curious" not in text:
                out["input_ids"] = out["input_ids"] + [99]
            return out

    src = [_sources()[0]]
    got = tokenization.preprocess_sep2(copy.deepcopy(src), BrokenTok(), "conv_sep2")
    ref = jtok.preprocess_sep2(copy.deepcopy(src), BrokenTok(), "conv_sep2")
    assert (got["labels"][0] == constants.IGNORE_INDEX).all()
    np.testing.assert_array_equal(got["labels"][0], ref["labels"][0])
    with pytest.raises(ValueError):
        tokenization.preprocess_sep2(copy.deepcopy(src), ToyLlamaTokenizer(), "conv_simple")


def test_image_and_video_spans_match_jax():
    conv = [{"from": "human", "value": "Describe it. <image>"}, {"from": "gpt", "value": "ok"}]
    a = jtok.preprocess_image_text(copy.deepcopy(conv), 4)
    b = tokenization.preprocess_image_text(copy.deepcopy(conv), 4)
    assert a == b and b[0][0]["value"].startswith("<img_beg>" + "<image_patch>" * 4 + "</img_end>")
    v = [{"from": "human", "value": "What happens?"}]
    assert jtok.preprocess_video_text(copy.deepcopy(v), 3) == tokenization.preprocess_video_text(
        copy.deepcopy(v), 3)


@pytest.mark.parametrize("keywords", [["</s>"], ["###"], ["[SEG]", "</s>", "two words"]])
def test_keyword_stop_ids_match_jax(keywords):
    ids = []
    for mod in (jtools, tools):
        tok = ToyLlamaTokenizer()
        tok.add_tokens(constants.MM_TOKENS + constants.STAGE2_TOKENS)
        ids.append(mod.keyword_stop_ids(tok, keywords))
    assert ids[0] == ids[1] and ToyLlamaTokenizer().eos_token_id in ids[1]


CFG = {
    "model": {"arch": "ullava", "llm_path": "x", "conv_type": "conv_sep2",
              "quantize": "int8", "lora_r": 8},
    "task": {"type": "image_text_pretrain", "collator_type": "image_collator"},
    "processor": {"clip_image": {"image_size": 224, "aspect_ratio": "pad"}},
    "dataset": {"llava_cc3m": {"data_type": "image", "build_info": {"portion": 1.0}}},
    "training": {"learning_rate": 2e-3, "bf16": True, "steps": [1, 2, {"n": 3}]},
}


def _registered():
    import ullava_tpu.models.build  # noqa: F401
    import ullava_tpu_torch.models.build  # noqa: F401


def test_config_from_dict_and_yaml_match_jax(tmp_path):
    _registered()
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(CFG))
    for kw in ({"cfg_dict": CFG}, {"cfg_path": str(path)}):
        got, ref = config.Config(**kw), jconfig.Config(**kw)
        assert got.to_dict() == ref.to_dict()
        parts = got.assign_config()
        assert [p.to_dict() for p in parts] == [p.to_dict() for p in ref.assign_config()]
        model, dataset, eval_ds, training, task, processor = parts
        assert model.quantize == "int8" and model.get("kv_cache") is None
        assert dataset.llava_cc3m.build_info.portion == 1.0 and dict(eval_ds) == {}
        assert training.steps[2].n == 3 and processor["clip_image"].aspect_ratio == "pad"
        assert registry.get("configuration") is got
    assert got.pretty_print() == ref.pretty_print()
    node = config.ConfigNode({"a": {"b": 1}, "c": 2})
    node.merge_from({"a": {"d": 3}})
    assert node.to_dict() == {"a": {"b": 1, "d": 3}, "c": 2}


def test_config_and_registry_errors():
    _registered()
    for bad in ({k: v for k, v in CFG.items() if k != "training"},
                {**CFG, "model": {"arch": "not_registered"}},
                {k: v for k, v in CFG.items() if k != "model"}):
        with pytest.raises(KeyError):
            config.Config(cfg_dict=bad)
        with pytest.raises(KeyError):
            jconfig.Config(cfg_dict=bad)
    with pytest.raises(ValueError):
        config.Config()
    assert registry.list_names("model") == ["ullava", "ullava_core"]
    assert registry.get_processor_class("clip_image") is None or \
        registry.get_processor_class("clip_image").__module__.startswith("ullava_tpu_torch")

    reg = Registry()

    @reg.register_task("t")
    class T1:
        pass

    assert reg.get_task_class("t") is T1 and reg.get_task_class("nope") is None
    reg.register("answer", 42)
    assert reg.get("answer") == 42 and reg.get("missing", default="d") == "d"
    reg.unregister("answer")
    assert reg.get("answer") is None
    with pytest.raises(KeyError):

        @reg.register_task("t")
        class T2:
            pass
