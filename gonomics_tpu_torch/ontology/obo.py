"""OBO ontology terms: reading, writing and the DAG walks; a copy of
``gonomics_tpu/ontology/obo.py`` (235 lines, whole), gonomics'
``ontology/obo/{obo,tree}.go``.

``read`` takes every line before the first ``[Term]`` as the header and
skips ``#`` lines only after it; a ``[Typedef]`` stanza is dropped at its
blank line, and a last stanza with no blank line after it is dropped.
``_process_term`` splits each line on ``": "``; without ``force`` a
second id, name, namespace or def, a missing name, namespace or def, or
a parent id that is not in the file exits. ``Obo``'s ``parents`` and
``children`` point at each other, so its generated ``==`` and ``repr``
recurse without end: compare ids and fields. ``_term_to_dot`` writes a
child's edge even where the child was visited before."""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import fileio


@dataclass
class Obo:
    """obo.Obo (obo.go:13)."""

    id: str = ""
    name: str = ""
    namespace: str = ""
    definition: str = ""
    is_obsolete: bool = False
    is_a: list[tuple[str, list[str]]] = field(default_factory=list)
    synonyms: list[str] = field(default_factory=list)
    xrefs: list[str] = field(default_factory=list)
    alt_ids: list[str] = field(default_factory=list)
    relationships: list[str] = field(default_factory=list)
    comments: list[str] = field(default_factory=list)
    other_fields: dict[str, list[str]] = field(default_factory=dict)
    parents: list["Obo"] = field(default_factory=list)
    children: list["Obo"] = field(default_factory=list)
    subtree_size: int = 0


def _process_term(lines: list[str], force: bool) -> Obo:
    """processOboTerm (obo.go:118)."""
    answer = Obo()
    for line in lines:
        key, sep, value = line.partition(": ")
        if not sep:
            if line != "[Term]":
                raise SystemExit("Error: Unrecognized line in entry: "
                                 f"{line}")
            continue
        if key == "id":
            if answer.id and not force:
                raise SystemExit("Error: more than one ID found")
            answer.id = value
        elif key == "name":
            if answer.name and not force:
                raise SystemExit("Error: more than one name found")
            answer.name = value
        elif key == "namespace":
            if answer.namespace and not force:
                raise SystemExit("Error: more than one namespace found")
            answer.namespace = value
        elif key == "def":
            if answer.definition and not force:
                raise SystemExit("Error: more than one def found")
            answer.definition = value
        elif key == "is_obsolete":
            if value != "true":
                raise SystemExit("Error: Unrecognized entry after "
                                 "is_obsolete")
            answer.is_obsolete = True
        elif key == "is_a":
            words = value.split(" ")
            answer.is_a.append((words[0], words[1:]))
        elif key == "synonym":
            answer.synonyms.append(value)
        elif key == "xref":
            answer.xrefs.append(value)
        elif key == "alt_id":
            answer.alt_ids.append(value)
        elif key == "relationship":
            answer.relationships.append(value)
        elif key == "comment":
            answer.comments.append(value)
        else:
            answer.other_fields.setdefault(key, []).append(value)
    if not answer.id:
        raise SystemExit("Error: 'id' not found in term")
    if not force and not (answer.name and answer.namespace
                          and answer.definition):
        raise SystemExit("Error: required obo field missing in term")
    return answer


def read(filename: str, force: bool = False) \
        -> tuple[dict[str, Obo], list[str]]:
    """obo.Read (obo.go:77): (id->Obo map with linked DAG, header)."""
    header: list[str] = []
    terms: dict[str, Obo] = {}
    lines: list[str] = []
    in_header = True
    with fileio.easy_open(filename) as f:
        all_lines = [ln.rstrip("\n") for ln in f]
    for line in all_lines:
        if in_header:
            if line.startswith("[Term]"):
                in_header = False
            else:
                header.append(line)
                continue
        if line.startswith("#"):
            continue
        if line == "":
            if lines and lines[0] == "[Typedef]":
                lines = []
            elif lines:
                term = _process_term(lines, force)
                terms[term.id] = term
                lines = []
        else:
            lines.append(line)
    # a final entry without a trailing blank line is dropped, matching
    # NextObo's EOF behavior (obo.go:97-113)
    _build_tree(terms, force)
    return terms, header


def _build_tree(terms: dict[str, Obo], force: bool) -> None:
    """buildTree (tree.go:10)."""
    for term in terms.values():
        for parent_id, _ in term.is_a:
            parent = terms.get(parent_id)
            if parent is not None:
                term.parents.append(parent)
                parent.children.append(term)
            elif not force:
                raise SystemExit(
                    f'Error: The term with ID "{term.id}" has a parent '
                    f'with ID "{parent_id}" that is not found.')


def to_string(o: Obo) -> str:
    """obo.ToString (obo.go:228)."""
    out = (f"[Term]\nid: {o.id}\nname: {o.name}\n"
           f"namespace: {o.namespace}\ndef: {o.definition}\n")
    if o.is_obsolete:
        out += "is_obsolete: true\n"
    for pid, info in o.is_a:
        out += "is_a: " + " ".join([pid] + info) + "\n"
    for s in o.synonyms:
        out += f"synonym: {s}\n"
    for x in o.xrefs:
        out += f"xref: {x}\n"
    for a in o.alt_ids:
        out += f"alt_id: {a}\n"
    for r in o.relationships:
        out += f"relationship: {r}\n"
    for c in o.comments:
        out += f"comment: {c}\n"
    for key, vals in o.other_fields.items():
        for v in vals:
            out += f"{key}: {v}\n"
    return out


def write(filename: str, records: dict[str, Obo],
          header: list[str]) -> None:
    with fileio.easy_create(filename) as f:
        for line in header:
            f.write(line + "\n")
        for term in records.values():
            f.write(to_string(term) + "\n")


def find_tree_roots(records: dict[str, Obo]) -> list[Obo]:
    """obo.FindTreeRoots (tree.go:31)."""
    return [t for t in records.values() if not t.parents]


def to_dot(out_file: str, terms: dict[str, Obo]) -> None:
    """obo.ToDot (tree.go:58)."""
    visited: set[str] = set()
    with fileio.easy_create(out_file) as out:
        out.write("digraph G{\n")
        for term in terms.values():
            _term_to_dot(term, out, visited)
        out.write("}\n")


def _term_to_dot(term: Obo, out, visited: set[str]) -> None:
    if term.id in visited:
        return
    visited.add(term.id)
    out.write(f'"{term.id}" [label = "{term.name}"];\n')
    for child in term.children:
        out.write(f'"{term.id}" -> "{child.id}";\n')
        _term_to_dot(child, out, visited)


def subtree_to_dot(out_file: str, node_id: str,
                   terms: dict[str, Obo]) -> None:
    """obo.SubtreeToDot (tree.go:102): includes alt-id resolution."""
    term_map: dict[str, Obo] = {}
    for t in terms.values():
        term_map[t.id] = t
        for alt in t.alt_ids:
            term_map[alt] = t
    if node_id not in term_map:
        raise SystemExit(f"Input term not found in Obo file. Term: "
                         f"{node_id}")
    visited: set[str] = set()
    with fileio.easy_create(out_file) as out:
        out.write("digraph G {\n")
        _term_to_dot(term_map[node_id], out, visited)
        out.write("}\n")


def number_of_descendents(records: dict[str, Obo]) -> None:
    """obo.NumberOfDescendents (tree.go:131)."""
    visited: set[str] = set()
    for term in records.values():
        _descendents_recursive(term, visited)


def _descendents_recursive(term: Obo, visited: set[str]) -> None:
    if term.id in visited:
        return
    visited.add(term.id)
    term.subtree_size = 1
    for child in term.children:
        _descendents_recursive(child, visited)
        term.subtree_size += child.subtree_size


def subtree_report(out_file: str, records: dict[str, Obo]) -> None:
    """obo.SubTreeReport (tree.go:163)."""
    with fileio.easy_create(out_file) as out:
        for t in records.values():
            out.write(f"{t.subtree_size}\tId: {t.id}. Name: {t.name}. "
                      f"Descendents: {t.subtree_size}\n")
