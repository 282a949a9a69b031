"""eve visitor-dispatch micro-benchmarks.

Counterpart of the reference's
tests/eve_tests/benchmarks/benchmark_eve_visitors.py: per-node dispatch
cost of NodeVisitor / NodeTranslator / TemplatedGenerator over a deep
synthetic IR tree. These bound the compile-time overhead of every
analysis pass (the passes run at stencil-build time only —
never per call — but frontend latency still matters for JIT workflows).

Run: python benchmarks/benchmark_eve_visitors.py
Prints one JSON line per benchmark.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gt4py_tpu.eve import codegen
from gt4py_tpu.eve.concepts import Node, datamodel
from gt4py_tpu.eve.visitors import NodeTranslator, NodeVisitor


@datamodel
class Num(Node):
    value: int = 0


@datamodel
class Add(Node):
    left: Node = None  # type: ignore[assignment]
    right: Node = None  # type: ignore[assignment]


def build_tree(depth: int) -> Node:
    if depth == 0:
        return Num(value=1)
    return Add(left=build_tree(depth - 1), right=build_tree(depth - 1))


def count_nodes(root: Node) -> int:
    if isinstance(root, Num):
        return 1
    return 1 + count_nodes(root.left) + count_nodes(root.right)


class SumVisitor(NodeVisitor):
    def visit_Num(self, node, **kwargs):
        self.total = getattr(self, "total", 0) + node.value

    def visit_Add(self, node, **kwargs):
        self.visit(node.left)
        self.visit(node.right)


class Doubler(NodeTranslator):
    def visit_Num(self, node, **kwargs):
        return Num(value=2 * node.value)


class Printer(codegen.TemplatedGenerator):
    Num = codegen.FormatTemplate("{value}")
    Add = codegen.FormatTemplate("({left} + {right})")


def timeit(fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def main() -> None:
    depth = 14  # 2^15 - 1 = 32767 nodes
    tree = build_tree(depth)
    n_nodes = count_nodes(tree)

    def bench(name, fn):
        t = timeit(fn)
        print(
            json.dumps(
                {
                    "benchmark": name,
                    "nodes": n_nodes,
                    "us_total": round(t * 1e6, 1),
                    "ns_per_node": round(t / n_nodes * 1e9, 1),
                }
            )
        )

    def run_visitor():
        v = SumVisitor()
        v.visit(tree)

    bench("node_visitor_dispatch", run_visitor)
    bench("node_translator_rebuild", lambda: Doubler().visit(tree))
    bench("templated_generator_render", lambda: Printer.apply(tree))

    from gt4py_tpu.eve.trees import walk_values

    bench("tree_walk_values", lambda: sum(1 for _ in walk_values(tree)))


if __name__ == "__main__":
    main()
