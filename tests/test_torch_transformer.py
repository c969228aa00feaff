"""The port's ProseMirror / Tiptap transformer against the JAX package's.

The same JSON goes through both packages' `to_ydoc` and `from_ydoc`:
the round trips are equal, and with the client id fixed the encoded
state of `to_ydoc` is equal byte for byte, so a document one package
imports is the document the other would have made. Marks, attributes
(None ones dropped), nested nodes, empty fields, several fields and the
cases of tests/transformer/test_prosemirror.py are covered, plus seeded
random trees.
"""

import numpy as np
import pytest

from hocuspocus_tpu import crdt as jax_crdt
from hocuspocus_tpu import transformer as jax_transformer
from hocuspocus_tpu.crdt import doc as jax_doc_module
from hocuspocus_tpu_torch import crdt as port_crdt
from hocuspocus_tpu_torch import transformer as port_transformer
from hocuspocus_tpu_torch.crdt import doc as port_doc_module

from chip_smoke import make_pm_doc

SIMPLE_DOC = {
    "type": "doc",
    "content": [{"type": "paragraph", "content": [{"type": "text", "text": "hello world"}]}],
}

RICH_DOC = {
    "type": "doc",
    "content": [
        {"type": "heading", "attrs": {"level": 1}, "content": [{"type": "text", "text": "Title"}]},
        {
            "type": "paragraph",
            "content": [
                {"type": "text", "text": "plain "},
                {"type": "text", "text": "bold", "marks": [{"type": "bold"}]},
                {
                    "type": "text",
                    "text": " link",
                    "marks": [{"type": "link", "attrs": {"href": "https://x.test"}}],
                },
            ],
        },
    ],
}

NESTED_DOC = {
    "type": "doc",
    "content": [
        {
            "type": "bulletList",
            "content": [
                {
                    "type": "listItem",
                    "content": [
                        {
                            "type": "paragraph",
                            "content": [
                                {"type": "text", "text": "one "},
                                {
                                    "type": "text",
                                    "text": "two",
                                    "marks": [{"type": "italic"}, {"type": "bold"}],
                                },
                            ],
                        }
                    ],
                },
                {"type": "listItem", "content": [{"type": "paragraph"}]},
            ],
        },
        {"type": "blockquote", "content": [{"type": "paragraph", "content": [{"type": "text", "text": "q"}]}]},
        {"type": "horizontalRule"},
        {"type": "image", "attrs": {"src": "a.png", "alt": None, "width": 30}},
        {"type": "paragraph"},
    ],
}

EMPTY_FIELD_DOC = {"type": "doc", "content": []}


MARKS = [
    {"type": "bold"},
    {"type": "italic"},
    {"type": "code"},
    {"type": "link", "attrs": {"href": "https://y.test"}},
    {"type": "highlight", "attrs": {"color": "#ff0"}},
]


def random_doc(rng, depth: int = 0) -> dict:
    """A seeded ProseMirror tree: blocks with attributes, marked text runs
    (adjacent runs differ in marks, as ProseMirror keeps them), nesting."""
    blocks = []
    for _ in range(int(rng.integers(0, 4 if depth else 6))):
        kind = int(rng.integers(0, 4))
        if kind == 0 and depth < 2:
            blocks.append({"type": "blockquote", "content": random_doc(rng, depth + 1)["content"] or [{"type": "paragraph"}]})
            continue
        node = {"type": ["paragraph", "heading", "codeBlock", "paragraph"][kind]}
        if kind == 1:
            node["attrs"] = {"level": int(rng.integers(1, 4))}
        if kind == 2:
            node["attrs"] = {"language": "py"}
        runs, last = [], None
        for _ in range(int(rng.integers(0, 5))):
            pick = int(rng.integers(-1, len(MARKS)))
            if pick == last:
                continue
            last = pick
            text = "".join(chr(int(c)) for c in rng.integers(97, 123, int(rng.integers(1, 8))))
            run = {"type": "text", "text": text}
            if pick >= 0:
                run["marks"] = [MARKS[pick]]
            runs.append(run)
        if runs:
            node["content"] = runs
        blocks.append(node)
    return {"type": "doc", "content": blocks}


@pytest.fixture
def fixed_client_id(monkeypatch):
    for module in (jax_doc_module, port_doc_module):
        monkeypatch.setattr(module, "generate_new_client_id", lambda: 424242)


def _both(document, field):
    jax_ydoc = jax_transformer.ProsemirrorTransformer.to_ydoc(document, field)
    port_ydoc = port_transformer.ProsemirrorTransformer.to_ydoc(document, field)
    return jax_ydoc, port_ydoc


CASES = {
    "simple": SIMPLE_DOC,
    "rich": RICH_DOC,
    "nested": NESTED_DOC,
    "empty_field": EMPTY_FIELD_DOC,
    "config3": make_pm_doc(7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_to_ydoc_bytes_and_round_trip_are_equal(case, fixed_client_id):
    document = CASES[case]
    jax_ydoc, port_ydoc = _both(document, "prosemirror")
    assert port_ydoc.client_id == jax_ydoc.client_id == 424242
    encoded = port_crdt.encode_state_as_update(port_ydoc)
    assert encoded == jax_crdt.encode_state_as_update(jax_ydoc)
    port_back = port_transformer.ProsemirrorTransformer.from_ydoc(port_ydoc, "prosemirror")
    jax_back = jax_transformer.ProsemirrorTransformer.from_ydoc(jax_ydoc, "prosemirror")
    assert port_back == jax_back
    expected = document if case != "nested" else jax_back  # None attrs are dropped
    assert port_back == expected
    # each package reads the other's bytes back to the same JSON
    port_doc, jax_doc = port_crdt.Doc(), jax_crdt.Doc()
    port_crdt.apply_update(port_doc, jax_crdt.encode_state_as_update(jax_ydoc))
    jax_crdt.apply_update(jax_doc, encoded)
    assert port_transformer.ProsemirrorTransformer.from_ydoc(port_doc, "prosemirror") == jax_back
    assert jax_transformer.ProsemirrorTransformer.from_ydoc(jax_doc, "prosemirror") == port_back


def test_nested_drops_none_attributes_as_the_reference_does():
    back = port_transformer.ProsemirrorTransformer.from_ydoc(
        port_transformer.ProsemirrorTransformer.to_ydoc(NESTED_DOC, "pm"), "pm"
    )
    image = back["content"][3]
    assert image == {"type": "image", "attrs": {"src": "a.png", "width": 30}}
    assert back["content"][0]["content"][1] == {"type": "listItem", "content": [{"type": "paragraph"}]}


@pytest.mark.parametrize("seed", range(6))
def test_seeded_trees_are_equal(seed, fixed_client_id):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        document = random_doc(rng)
        if not document["content"]:
            continue
        jax_ydoc, port_ydoc = _both(document, ["a", "b"])
        assert port_crdt.encode_state_as_update(port_ydoc) == jax_crdt.encode_state_as_update(jax_ydoc)
        port_back = port_transformer.ProsemirrorTransformer.from_ydoc(port_ydoc)
        assert port_back == jax_transformer.ProsemirrorTransformer.from_ydoc(jax_ydoc)
        assert port_back["a"] == port_back["b"] == document


def test_tiptap_default_field_and_all_fields(fixed_client_id):
    jax_ydoc = jax_transformer.TiptapTransformer.to_ydoc(RICH_DOC)
    port_ydoc = port_transformer.TiptapTransformer.to_ydoc(RICH_DOC)
    assert port_crdt.encode_state_as_update(port_ydoc) == jax_crdt.encode_state_as_update(jax_ydoc)
    assert port_transformer.TiptapTransformer.from_ydoc(port_ydoc, "default") == RICH_DOC
    assert port_transformer.TiptapTransformer.from_ydoc(port_ydoc) == {"default": RICH_DOC}
    assert port_transformer.TiptapTransformer.extensions(["x"]).default_extensions == ["x"]


def test_text_roots_read_through_the_xml_view():
    """A Y.Text document read by the transformer (the webhook's onChange
    on a plain-text doc): string runs become text nodes in both."""
    out = {}
    for name, crdt, transformer in (
        ("jax", jax_crdt, jax_transformer),
        ("port", port_crdt, port_transformer),
    ):
        doc = crdt.Doc()
        doc.get_text("default").insert(0, "plain text body")
        update = crdt.encode_state_as_update(doc)
        reader = crdt.Doc()
        crdt.apply_update(reader, update)
        out[name] = transformer.TiptapTransformer.from_ydoc(reader, "default")
    assert out["port"] == out["jax"]
    assert out["port"] == {"type": "doc", "content": [{"type": "text", "text": "plain text body"}]}


@pytest.mark.parametrize("bad", [None, {}, ""])
def test_empty_document_raises_in_both(bad):
    for transformer in (jax_transformer, port_transformer):
        with pytest.raises(ValueError):
            transformer.ProsemirrorTransformer.to_ydoc(bad)
