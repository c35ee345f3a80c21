"""dy2static: AST conversion of Python control flow for ``to_static``
(the port of ``paddle_tpu/jit/dy2static.py``; reference analog
python/paddle/jit/dy2static/program_translator.py:1225 and
convert_operators.py's convert_ifelse / convert_while_loop).

The same source-to-source rewrite as the reference's, targeting the
torch higher-order ops behind ``static.control_flow``.  Each `if` /
`while` statement becomes a call to a runtime helper that dispatches on
the predicate: a concrete predicate runs plain Python (eager semantics
kept), a predicate that is a tensor under ``to_static``'s capture (a
fake tensor of ``torch.export``) lowers to ``torch.cond`` /
``torch._higher_order_ops.while_loop``.  Variables assigned inside a
branch are threaded as explicit inputs and outputs of generated
closures (the get_args/set_args analog); names that may be unbound
before the branch are seeded with an UNDEFINED sentinel the helpers
refuse to return from a taken traced branch.

Conversion contract (the reference's documented subset):
- `if`/`elif`/`else` and `while` with tensor or Python predicates;
- `for` over range(...) (desugared to while; other iterables unroll);
- `break`/`continue` in converted loops (carried flags with guarded
  tails, the reference's break_continue_transformer strategy);
- branch and loop bodies that assign plain names (tuple targets ok);
- early `return` inside `if` chains (the reference's return_transformer):
  every path must then return values of one structure; `return` inside
  a converted loop stays unsupported (the loop is left as Python);
- `for` over tensors / enumerate / zip keeps Python semantics and
  unrolls at capture time;
- Python list `append`/`extend` in loops works while the loop unrolls;
  a loop that goes traced while mutating a Python container raises the
  reference's error naming the container;
- `yield` is not supported in converted blocks;
- code without retrievable source, lambdas, closures and foreign
  decorators fall back to plain capture.

Under the capture every tensor is a fake tensor, constants made inside
the function included, so a tensor predicate the reference would find
concrete (a ``to_tensor`` constant) lowers here too: both give the same
values, but a Python container mutated in such a loop is refused here
(ROADMAP C).  The generated names carry the ``__ptt_`` prefix, apart
from the reference's ``__pt_``, so both packages can convert functions
of one module.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap
from typing import Any, Callable, Dict

import torch

__all__ = ["convert_to_static", "convert_ifelse", "convert_while_loop",
           "UNDEFINED"]


class _Undefined:
    def __repr__(self):
        return "<dy2static UNDEFINED>"


UNDEFINED = _Undefined()


def _raw(x):
    return getattr(x, "_t", x)


def _is_traced(x) -> bool:
    from ..static.control_flow import is_traced
    return is_traced(_raw(x))


def _wrap(t):
    from ..core.tensor import Tensor
    return Tensor._wrap(t)


# set_verbosity / set_code_level knobs (jit.api wraps these)
_VERBOSITY = [0]
_CODE_LEVEL = [0]

_ONE_SIDED_MSG = (
    "dy2static: a variable assigned in only one branch of a "
    "tensor-predicated `if` stayed undefined in the other; assign it "
    "before the `if` or in both branches")


def convert_ifelse(pred, true_fn, false_fn, vals):
    """Runtime dispatch for a rewritten `if` (convert_ifelse analog).
    vals: tuple of the variables either branch may assign; both branches
    return the updated tuple.  UNDEFINED leaves coming out of a taken
    concrete branch are handled by the generated `del` cleanup; a traced
    branch returning UNDEFINED raises the clear message during capture."""
    if not _is_traced(pred):
        return true_fn(*vals) if bool(_raw(pred)) else false_fn(*vals)
    from ..static.control_flow import cond

    def checked(fn):
        def g():
            out = fn(*vals)
            if any(v is UNDEFINED for v in out):
                raise ValueError(_ONE_SIDED_MSG)
            return out
        return g

    return cond(pred, checked(true_fn), checked(false_fn))


def _bool_tensor(x, like):
    t = _raw(x)
    if not torch.is_tensor(t):
        t = torch.tensor(bool(t), device=like.device)
    return t if t.dtype == torch.bool else t != 0


def convert_not_any(a, b):
    """``not (a or b)`` without Python short-circuiting: the operands
    may be traced break/continue flags."""
    if _is_traced(a) or _is_traced(b):
        like = _raw(a) if _is_traced(a) else _raw(b)
        return _wrap(torch.logical_not(torch.logical_or(
            _bool_tensor(a, like), _bool_tensor(b, like))))
    return not (bool(_raw(a)) or bool(_raw(b)))


def convert_and_not(cond, flag):
    """``cond and not flag`` for loop tests, traced-aware."""
    if _is_traced(cond) or _is_traced(flag):
        like = _raw(cond) if _is_traced(cond) else _raw(flag)
        return _wrap(torch.logical_and(_bool_tensor(cond, like),
                                       torch.logical_not(
                                           _bool_tensor(flag, like))))
    return bool(_raw(cond)) and not bool(_raw(flag))


def convert_assert(test, msg=None):
    """Runtime dispatch for a rewritten ``assert`` (reference:
    convert_assert -> the Assert op).  Concrete predicates keep Python
    semantics; a traced predicate becomes an ``_assert_async`` node that
    raises at run time with the assertion's message (evaluated at
    capture), instead of the data-dependent error a Python assert would
    die with at capture."""
    import numpy as np

    v = _raw(test)
    if _is_traced(test):
        m = msg() if callable(msg) else msg
        torch._assert_async(
            torch.all(v), str(m) if m is not None else
            "Assert failed on a traced predicate inside a to_static "
            "function")
        return
    # concrete: Python truthiness ('assert items' on a non-empty list
    # must pass); all() only for tensor-valued predicates
    if torch.is_tensor(v):
        ok = bool(torch.all(v))
    elif isinstance(v, np.ndarray):
        ok = bool(np.all(v))
    else:
        ok = bool(test)
    if not ok:
        m = msg() if callable(msg) else msg
        raise AssertionError(m) if m is not None else AssertionError()


def convert_flag_off(flag):
    """1 when the flag is unset, 0 when set (traced-aware): multiplies
    the for-loop index bump so `break` keeps the loop variable (Python
    leaves it at the breaking iteration) while `continue` advances it."""
    if _is_traced(flag):
        f = _raw(flag)
        return _wrap(torch.where(f, 0, 1).to(torch.int64))
    return 0 if bool(_raw(flag)) else 1


def convert_while_loop(cond_fn, body_fn, vals, mutates=()):
    """Runtime dispatch for a rewritten `while`.  The probe can turn
    traced mid-loop (a concrete range bound with a tensor-predicated
    break: the first iterations run in Python until the ``torch.cond``
    makes the flag a tensor); the loop then re-dispatches to the traced
    path with the current carry.

    mutates: names of Python containers the body mutates in place
    (``lst.append(...)``): legal while the loop unrolls, impossible once
    it lowers to a traced while loop (one trace of the body would run
    the mutation once) -- raise the reference's clear error."""
    probe = cond_fn(*vals)
    while not _is_traced(probe):
        if not bool(_raw(probe)):
            return vals
        vals = body_fn(*vals)
        probe = cond_fn(*vals)
    if mutates:
        raise ValueError(
            "dy2static: a tensor-predicated while mutates python "
            f"container(s) {list(mutates)}; list operations cannot be "
            "carried through a traced while loop -- preallocate with "
            "paddle.tensor.create_array/array_write (concrete size), "
            "use a stacked tensor carry, or keep the loop bound "
            "concrete so the loop unrolls")
    if any(v is UNDEFINED for v in vals):
        raise ValueError(
            "dy2static: a loop variable of a tensor-predicated `while` "
            "is unbound before the loop; assign it first (the traced "
            "loop needs its carry defined on entry)")
    from ..static.control_flow import while_loop
    out = while_loop(lambda *a: cond_fn(*a), lambda *a: body_fn(*a),
                     list(vals))
    return tuple(out)


class _CollectAssigns(ast.NodeVisitor):
    def __init__(self):
        self.names = []

    def visit_Assign(self, node):
        for t in node.targets:
            self._collect(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._collect(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._collect(node.target)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        # nested defs are not threaded through cond/while (function
        # objects aren't tensors); they stay local to their branch
        pass

    def visit_Lambda(self, node):
        pass

    def _collect(self, target):
        if isinstance(target, ast.Name):
            if target.id not in self.names:
                self.names.append(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._collect(e)
        # attribute/subscript targets mutate objects, not names: the
        # closure sees the mutation without threading


def _assigned_names(stmts) -> list:
    c = _CollectAssigns()
    for s in stmts:
        c.visit(s)
    return c.names


_BLOCKERS = (ast.Return, ast.Break, ast.Continue, ast.Yield,
             ast.YieldFrom, ast.Global, ast.Nonlocal)


def _has_blocker(stmts) -> bool:
    """True when the block contains control-transfer statements this pass
    can't rewrite. Nested function scopes are opaque — a `return` inside
    an inner def (including the closures a previous rewrite generated)
    does not transfer control out of THIS block."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, _BLOCKERS):
                return True
            if walk(child):
                return True
        return False

    for s in stmts:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(s, _BLOCKERS):
            return True
        if walk(s):
            return True
    return False


def _any_return(stmts) -> bool:
    """Return statements in this suite or nested `if` chains (loops and
    nested function scopes are opaque: their returns are handled by
    python directly / belong to the inner function)."""
    for st in stmts:
        if isinstance(st, ast.Return):
            return True
        if isinstance(st, ast.If) and (_any_return(st.body)
                                       or _any_return(st.orelse)):
            return True
    return False


def _lowered_volume(seq, budget: int) -> int:
    """Estimate how many statements _lower_returns' tail duplication
    would emit for ``seq`` — by mirroring process()'s recursion with
    counts instead of nodes. Nested returning-ifs duplicate their tail
    into BOTH arms, so the true cost is exponential in nesting depth; a
    flat count of returning ifs bounds the count, not the 2^depth
    blow-up. Clamped: any subtree pushing past ``budget`` returns
    ``budget + 1`` immediately, so the estimate itself stays O(budget).
    """
    n = 0
    for i, st in enumerate(seq):
        if n > budget:
            return n
        if isinstance(st, ast.Return):
            return n + 1
        if isinstance(st, ast.If) and (_any_return(st.body)
                                       or _any_return(st.orelse)):
            rest = seq[i + 1:]
            b = _lowered_volume(list(st.body) + rest, budget - n)
            if n + b > budget:
                return budget + 1
            e = _lowered_volume(list(st.orelse) + rest, budget - n - b)
            return n + 1 + b + e
        n += 1
    return n + 1


def _return_in_ifs(stmts) -> bool:
    # _any_return recurses into nested if chains, so one pass over the
    # top-level statements sees every convertible early return
    return any(isinstance(st, ast.If)
               and (_any_return(st.body) or _any_return(st.orelse))
               for st in stmts)


def _lower_returns(body, val):
    """Early-return lowering (reference: dy2static/return_transformer).

    Every `return e` inside the function's `if` structure becomes
    `<val> = e`, with the statements following a returning `if`
    duplicated into its non-returning paths, so control always falls to
    one final `return <val>` at the bottom. Paths that fall off the end
    assign None, matching python. Loops are untouched: a `return` inside
    them still exits the function directly (python semantics), which is
    correct because the final return is only reached by falling through.
    """
    def process(seq):
        out = []
        for i, st in enumerate(seq):
            if isinstance(st, ast.Return):
                out.append(ast.Assign(
                    targets=[ast.Name(id=val, ctx=ast.Store())],
                    value=st.value or ast.Constant(value=None)))
                return out  # anything after is unreachable
            if isinstance(st, ast.If) and (_any_return(st.body)
                                           or _any_return(st.orelse)):
                rest = seq[i + 1:]
                out.append(ast.If(
                    test=st.test,
                    body=process(list(st.body) + rest) or [ast.Pass()],
                    orelse=process(list(st.orelse) + rest)))
                return out
            out.append(st)
        # fell off the end of this path
        out.append(ast.Assign(targets=[ast.Name(id=val, ctx=ast.Store())],
                              value=ast.Constant(value=None)))
        return out

    new = process(list(body))
    new.append(ast.Return(value=ast.Name(id=val, ctx=ast.Load())))
    return new


def _reads_in(nodes):
    """Overapproximate set of names read anywhere in these nodes
    (including nested scopes — a closure read keeps a name live)."""
    reads = set()
    for node in nodes:
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                reads.add(n.id)
    return reads


def _mutated_containers(stmts):
    """Names whose in-place mutating methods are called in the block —
    candidates that cannot ride a traced loop carry."""
    muts = set()
    for s in stmts:
        for node in ast.walk(s):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("append", "extend", "insert")
                    and isinstance(node.func.value, ast.Name)):
                muts.add(node.func.value.id)
    return sorted(muts)


class _Rewriter(ast.NodeTransformer):
    """Rewrites if/while statements into helper calls with generated
    closures. Fresh names are prefixed __ptt_ to stay out of user space.

    global_names: names declared `global` anywhere at this function's
    scope — they can't be threaded as closure parameters (the seed would
    shadow and the cleanup would delete the module binding), so blocks
    assigning them are left unconverted."""

    def __init__(self, global_names=()):
        self.counter = 0
        self.converted = 0  # actual conversions (fresh-name allocation
        # alone must not defeat the caller's keep-original fallback)
        self.global_names = set(global_names)
        # liveness context: the set of names read after the statement
        # being visited (None = unknown -> thread conservatively). Names
        # assigned in a branch but never read later need not be threaded
        # through torch.cond — crucial for early-return lowering, whose
        # else-absorption creates branch-local locals that would
        # otherwise trip the one-sided UNDEFINED check.
        self._live = None

    def _visit_block(self, stmts, live_after):
        """Visit a suite giving each statement its reads-after set
        (live_after=None propagates the conservative unknown)."""
        out = []
        prev_live = self._live
        for i, st in enumerate(stmts):
            self._live = None if live_after is None else (
                _reads_in(stmts[i + 1:]) | live_after)
            r = self.visit(st)
            if isinstance(r, list):
                out.extend(r)
            elif r is not None:
                out.append(r)
        self._live = prev_live
        return out

    def visit_FunctionDef(self, node):
        # each function scope gets its own liveness context; at the end
        # of the suite nothing is live (returns read their value Names,
        # which _reads_in sees)
        node.body = self._visit_block(node.body, set())
        return node

    visit_AsyncFunctionDef = visit_FunctionDef

    def _fresh(self, kind):
        self.counter += 1
        return f"__ptt_{kind}_{self.counter}"

    # -- helpers -------------------------------------------------------
    def _make_fn(self, name, argnames, body_stmts, ret_names):
        """A generated closure.  Its body carries no ``locals()`` and no
        ``del``: a traced ``torch.cond`` / ``while_loop`` body is traced
        by dynamo, which follows neither.  Its parameters are bound on
        entry; a name a nested rewrite seeds that is not one of them is
        bound to the sentinel at the top instead (what the seed would
        have given it), and a nested rewrite's cleanup is dropped there,
        so a name no taken branch assigned stays the sentinel and flows
        out to the enclosing function's cleanup."""
        args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=a) for a in argnames],
            vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
            defaults=[])
        hoist: list = []

        def strip(seq):
            out = []
            for st in seq:
                seeded = self._seed_read_name(st)
                if seeded is not None:
                    if seeded not in argnames and seeded not in hoist:
                        hoist.append(seeded)
                    continue
                if self._is_cleanup(st):
                    continue
                if isinstance(st, (ast.If, ast.While, ast.For)):
                    st.body = strip(st.body) or [ast.Pass()]
                    st.orelse = strip(st.orelse)
                out.append(st)
            return out

        body = strip(list(body_stmts))
        top = [ast.Assign(targets=[ast.Name(id=n, ctx=ast.Store())],
                          value=ast.Name(id="__ptt_UNDEFINED",
                                         ctx=ast.Load())) for n in hoist]
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in ret_names],
            ctx=ast.Load()))
        return ast.FunctionDef(name=name, args=args,
                               body=top + body + [ret],
                               decorator_list=[], returns=None,
                               type_params=[])

    @staticmethod
    def _is_cleanup(st):
        """``if x is UNDEFINED: del x`` (``_cleanup_stmts``)."""
        return (isinstance(st, ast.If) and len(st.body) == 1
                and isinstance(st.body[0], ast.Delete)
                and isinstance(st.test, ast.Compare)
                and isinstance(st.test.comparators[0], ast.Name)
                and st.test.comparators[0].id == "__ptt_UNDEFINED")

    def _seed_stmt(self, name):
        # x = locals().get('x', UNDEFINED) — binds possibly-unbound names
        # so they can be threaded through the generated closures
        call = ast.Call(
            func=ast.Attribute(
                value=ast.Call(func=ast.Name(id="locals", ctx=ast.Load()),
                               args=[], keywords=[]),
                attr="get", ctx=ast.Load()),
            args=[ast.Constant(value=name),
                  ast.Name(id="__ptt_UNDEFINED", ctx=ast.Load())],
            keywords=[])
        return ast.Assign(
            targets=[ast.Name(id=name, ctx=ast.Store())], value=call)

    def _unpack_target(self, names):
        return ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Store())
                               for n in names], ctx=ast.Store())

    def _cleanup_stmts(self, names):
        # `if x is UNDEFINED: del x` — a name no taken branch assigned
        # goes back to being unbound, so later use raises
        # UnboundLocalError exactly like the unconverted python would
        out = []
        for n in names:
            test = ast.Compare(
                left=ast.Name(id=n, ctx=ast.Load()), ops=[ast.Is()],
                comparators=[ast.Name(id="__ptt_UNDEFINED",
                                      ctx=ast.Load())])
            out.append(ast.If(
                test=test,
                body=[ast.Delete(targets=[
                    ast.Name(id=n, ctx=ast.Del())])],
                orelse=[]))
        return out

    # -- break/continue lowering (loop_transformer's flag rewrite) -----
    def _loop_interrupts_present(self, stmts):
        """Break/Continue belonging to THIS loop: found in the block but
        not inside a nested loop or function scope."""
        def walk(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda,
                                      ast.For, ast.While, ast.AsyncFor)):
                    continue
                if isinstance(child, (ast.Break, ast.Continue)):
                    return True
                if walk(child):
                    return True
            return False
        return any(isinstance(s, (ast.Break, ast.Continue)) or walk(s)
                   for s in stmts)

    def _lower_loop_interrupts(self, stmts, brk, cont):
        """Rewrite this loop's break/continue into flag assignments and
        guard trailing statements so control falls to the loop bottom —
        the reference's break_continue_transformer strategy. Statements
        inside nested loops/functions are left alone (they belong to the
        inner scope). Returns (lowered_stmts, may_interrupt)."""
        def set_flag(name):
            return ast.Assign(
                targets=[ast.Name(id=name, ctx=ast.Store())],
                value=ast.Constant(value=True))

        def no_flags():
            return ast.Call(
                func=ast.Name(id="__ptt_not_any", ctx=ast.Load()),
                args=[ast.Name(id=brk, ctx=ast.Load()),
                      ast.Name(id=cont, ctx=ast.Load())],
                keywords=[])

        acc: list = []
        may_any = False
        for st in reversed(stmts):
            if isinstance(st, ast.Break):
                lowered, may = [set_flag(brk)], True
            elif isinstance(st, ast.Continue):
                lowered, may = [set_flag(cont)], True
            elif isinstance(st, ast.If):
                b, mb = self._lower_loop_interrupts(st.body, brk, cont)
                o, mo = self._lower_loop_interrupts(st.orelse, brk, cont)
                lowered = [ast.If(test=st.test, body=b or [ast.Pass()],
                                  orelse=o)]
                may = mb or mo
            else:
                lowered, may = [st], False
            if may and acc:
                acc = [ast.If(test=no_flags(), body=acc, orelse=[])]
            acc = lowered + acc
            may_any = may_any or may
        return acc, may_any

    @staticmethod
    def _seed_read_name(st):
        """The generated seed `x = locals().get('x', UNDEF)` reads x even
        though no Name-load appears; recognize it so carry analysis sees
        the read."""
        if (isinstance(st, ast.Assign) and isinstance(st.value, ast.Call)
                and isinstance(st.value.func, ast.Attribute)
                and st.value.func.attr == "get"
                and isinstance(st.value.func.value, ast.Call)
                and isinstance(st.value.func.value.func, ast.Name)
                and st.value.func.value.func.id == "locals"
                and st.value.args
                and isinstance(st.value.args[0], ast.Constant)):
            return st.value.args[0].value
        return None

    def _iteration_locals(self, stmts, names):
        """Subset of ``names`` that every iteration (re)binds by a
        top-level Assign before any read: per-iteration temporaries (a
        desugared inner loop's stop/step/loop-var), not loop state.
        Dropping them from the carry is what lets NESTED range loops
        convert — their temporaries would otherwise enter the outer
        traced carry as UNDEFINED seeds."""
        candidate = set(names)
        defined: set = set()
        must_carry: set = set()

        def loads_of(node):
            return {n.id for n in ast.walk(node)
                    if isinstance(n, ast.Name)
                    and isinstance(n.ctx, ast.Load)}

        for st in stmts:
            seed_name = self._seed_read_name(st)
            if seed_name is not None:
                if seed_name in candidate and seed_name not in defined:
                    must_carry.add(seed_name)
                defined.add(seed_name)
                continue
            if isinstance(st, ast.Assign):
                reads = loads_of(st.value)
                for t in st.targets:
                    if not isinstance(t, ast.Name):
                        reads |= loads_of(t)
                must_carry |= (reads & candidate) - defined
                for t in st.targets:
                    if isinstance(t, ast.Name):
                        defined.add(t.id)
            elif isinstance(st, ast.AugAssign):
                reads = loads_of(st.value)
                if isinstance(st.target, ast.Name):
                    reads.add(st.target.id)
                must_carry |= (reads & candidate) - defined
            else:
                must_carry |= (loads_of(st) & candidate) - defined
        return {n for n in candidate
                if n in defined and n not in must_carry}

    # -- transforms ----------------------------------------------------
    def visit_Assert(self, node):
        """assert test, msg -> __ptt_assert(test, msg): traced
        predicates become run-time checks instead of trace-time
        data-dependent errors (reference: convert_assert)."""
        self.generic_visit(node)
        # the message rides in a lambda: python evaluates an assert's
        # message LAZILY (only on failure) — `assert not errs, errs[0]`
        # must not crash on the passing path
        msg_arg = ast.Constant(value=None) if node.msg is None else \
            ast.Lambda(
                args=ast.arguments(posonlyargs=[], args=[],
                                   kwonlyargs=[], kw_defaults=[],
                                   defaults=[]),
                body=node.msg)
        call = ast.Expr(value=ast.Call(
            func=ast.Name(id="__ptt_assert", ctx=ast.Load()),
            args=[node.test, msg_arg], keywords=[]))
        self.converted += 1
        return ast.copy_location(call, node)

    def visit_If(self, node):
        live = self._live
        node.body = self._visit_block(node.body, live)
        node.orelse = self._visit_block(node.orelse, live)
        if _has_blocker(node.body) or _has_blocker(node.orelse):
            return node
        names = _assigned_names(node.body + node.orelse)
        # the global check must see every assigned name — a dead-store
        # global would be filtered from the carry below, but converting
        # would still move its assignment into a closure scope where the
        # missing `global` declaration makes it a local write
        if any(n in self.global_names for n in names):
            return node
        if live is not None:
            # branch-local names nothing ever reads again need not ride
            # the torch.cond carry (and must not: assigned one-sided from
            # an unbound start they would trip the UNDEFINED check)
            names = [n for n in names if n in live]
        if not names:
            return node
        self.converted += 1
        tname, fname = self._fresh("true"), self._fresh("false")
        stmts = [self._seed_stmt(n) for n in names]
        stmts.append(self._make_fn(tname, names, node.body, names))
        stmts.append(self._make_fn(fname, names, node.orelse or [ast.Pass()],
                                   names))
        call = ast.Call(
            func=ast.Name(id="__ptt_convert_ifelse", ctx=ast.Load()),
            args=[node.test,
                  ast.Name(id=tname, ctx=ast.Load()),
                  ast.Name(id=fname, ctx=ast.Load()),
                  ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                                  for n in names], ctx=ast.Load())],
            keywords=[])
        stmts.append(ast.Assign(targets=[self._unpack_target(names)],
                                value=call))
        stmts.extend(self._cleanup_stmts(names))
        return stmts

    def visit_For(self, node):
        """`for <name> in range(...)` desugars to the while machinery
        (reference: dy2static loop_transformer's for->while lowering), so
        traced loop bounds work. Other iterables keep python semantics —
        they unroll at trace time, which is correct for static
        containers."""
        live = self._live
        # visit the suites in place FIRST: every bail below returns
        # `node`, and nested conversions must survive the bail
        inner_live = None if live is None else (live | _reads_in([node]))
        node.body = self._visit_block(node.body, inner_live)
        node.orelse = self._visit_block(node.orelse, inner_live)
        if (node.orelse
                or not isinstance(node.target, ast.Name)
                or not isinstance(node.iter, ast.Call)
                or not isinstance(node.iter.func, ast.Name)
                or node.iter.func.id != "range"
                or node.iter.keywords
                or not 1 <= len(node.iter.args) <= 3):
            # non-range loops keep python semantics (trace-time unroll)
            return node
        body_stmts = list(node.body)
        flag_pre: list = []
        flag_test = None
        if self._loop_interrupts_present(body_stmts):
            # lower here (not in visit_While) so the index bump below
            # stays UNGUARDED: `continue` must still advance the loop var
            brk, cont = self._fresh("brk"), self._fresh("cont")
            if inner_live is not None:
                inner_live = inner_live | {brk, cont}
            body_stmts, _ = self._lower_loop_interrupts(body_stmts,
                                                        brk, cont)
            body_stmts = [ast.Assign(
                targets=[ast.Name(id=cont, ctx=ast.Store())],
                value=ast.Constant(value=False))] \
                + self._visit_block(body_stmts, inner_live)
            flag_pre = [ast.Assign(
                targets=[ast.Name(id=n, ctx=ast.Store())],
                value=ast.Constant(value=False)) for n in (brk, cont)]
            flag_test = ast.Name(id=brk, ctx=ast.Load())
        if _has_blocker(body_stmts):
            return node
        var = node.target.id
        a = node.iter.args
        start = a[0] if len(a) >= 2 else ast.Constant(value=0)
        stop = a[1] if len(a) >= 2 else a[0]
        step = a[2] if len(a) == 3 else ast.Constant(value=1)
        stop_n, step_n = self._fresh("stop"), self._fresh("step")
        pre = [
            ast.Assign(targets=[ast.Name(id=stop_n, ctx=ast.Store())],
                       value=stop),
            ast.Assign(targets=[ast.Name(id=step_n, ctx=ast.Store())],
                       value=step),
            ast.Assign(targets=[ast.Name(id=var, ctx=ast.Store())],
                       value=start),
        ]
        # (stop - i) * step > 0 — one comparison, correct for both signs
        test = ast.Compare(
            left=ast.BinOp(
                left=ast.BinOp(
                    left=ast.Name(id=stop_n, ctx=ast.Load()),
                    op=ast.Sub(),
                    right=ast.Name(id=var, ctx=ast.Load())),
                op=ast.Mult(),
                right=ast.Name(id=step_n, ctx=ast.Load())),
            ops=[ast.Gt()], comparators=[ast.Constant(value=0)])
        if flag_test is not None:
            test = ast.Call(
                func=ast.Name(id="__ptt_and_not", ctx=ast.Load()),
                args=[test, flag_test], keywords=[])
        step_expr = ast.Name(id=step_n, ctx=ast.Load())
        if flag_test is not None:
            # break preserves the loop var (bump * 0 when brk set);
            # continue still advances (cont does not zero the bump)
            step_expr = ast.BinOp(
                left=step_expr, op=ast.Mult(),
                right=ast.Call(
                    func=ast.Name(id="__ptt_flag_off", ctx=ast.Load()),
                    args=[ast.Name(id=flag_test.id, ctx=ast.Load())],
                    keywords=[]))
        bump = ast.Assign(
            targets=[ast.Name(id=var, ctx=ast.Store())],
            value=ast.BinOp(left=ast.Name(id=var, ctx=ast.Load()),
                            op=ast.Add(), right=step_expr))
        loop = ast.While(test=test, body=body_stmts + [bump],
                         orelse=[])
        lowered = self.visit_While(loop)
        return pre + flag_pre + (lowered if isinstance(lowered, list)
                                 else [lowered])

    def visit_While(self, node):
        live = self._live
        inner_live = None if live is None else (live | _reads_in([node]))
        # visit the suites in place FIRST: every bail below returns
        # `node`, and nested conversions must survive the bail
        node.body = self._visit_block(node.body, inner_live)
        node.orelse = self._visit_block(node.orelse, inner_live)
        if node.orelse:
            return node
        work, pre = node, []
        if self._loop_interrupts_present(node.body):
            brk, cont = self._fresh("brk"), self._fresh("cont")
            # the synthesized test/guards read the flags: they must stay
            # live (and in the carry) even though the pre-lowering AST
            # never mentions them
            if inner_live is not None:
                inner_live = inner_live | {brk, cont}
            lowered, _ = self._lower_loop_interrupts(node.body, brk, cont)
            body = [ast.Assign(
                targets=[ast.Name(id=cont, ctx=ast.Store())],
                value=ast.Constant(value=False))] \
                + self._visit_block(lowered, inner_live)
            test = ast.Call(
                func=ast.Name(id="__ptt_and_not", ctx=ast.Load()),
                args=[node.test, ast.Name(id=brk, ctx=ast.Load())],
                keywords=[])
            work = ast.While(test=test, body=body, orelse=[])
            pre = [ast.Assign(
                targets=[ast.Name(id=n, ctx=ast.Store())],
                value=ast.Constant(value=False)) for n in (brk, cont)]
        if _has_blocker(work.body):
            return node  # other control transfers remain unconvertible
        all_names = _assigned_names(work.body)
        local = self._iteration_locals(work.body, all_names)
        # the loop test runs before the body each iteration: names it
        # reads are loop state regardless of body-local rebinding
        local -= {n.id for n in ast.walk(work.test)
                  if isinstance(n, ast.Name)
                  and isinstance(n.ctx, ast.Load)}
        names = [n for n in all_names if n not in local]
        if any(n in self.global_names for n in names):
            return node  # see visit_If: globals must not enter closures
        if inner_live is not None:
            # dead stores (assigned, never read in the loop or after)
            # stay out of the carry: unbound before the loop they would
            # poison a traced carry with UNDEFINED seeds
            names = [n for n in names if n in inner_live]
        if not names:
            return node
        self.converted += 1
        cname, bname = self._fresh("cond"), self._fresh("body")
        stmts = pre + [self._seed_stmt(n) for n in names]
        cond_fn = self._make_fn(cname, names, [], [])
        cond_fn.body = [ast.Return(value=work.test)]
        stmts.append(cond_fn)
        stmts.append(self._make_fn(bname, names, work.body, names))
        muts = _mutated_containers(work.body)
        call = ast.Call(
            func=ast.Name(id="__ptt_convert_while", ctx=ast.Load()),
            args=[ast.Name(id=cname, ctx=ast.Load()),
                  ast.Name(id=bname, ctx=ast.Load()),
                  ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Load())
                                  for n in names], ctx=ast.Load())],
            keywords=[ast.keyword(
                arg="mutates",
                value=ast.Tuple(elts=[ast.Constant(value=m) for m in muts],
                                ctx=ast.Load()))] if muts else [])
        stmts.append(ast.Assign(targets=[self._unpack_target(names)],
                                value=call))
        stmts.extend(self._cleanup_stmts(names))
        return stmts


def _is_to_static_decorator(node) -> bool:
    """Syntactically recognize @to_static / @paddle.jit.to_static
    (optionally called) so exactly those are stripped from the rewrite."""
    if isinstance(node, ast.Call):
        node = node.func
    while isinstance(node, ast.Attribute):
        if node.attr == "to_static":
            return True
        node = node.value
    return isinstance(node, ast.Name) and node.id == "to_static"


def convert_to_static(fn: Callable) -> Callable:
    """Source-rewrite fn's control flow; returns fn unchanged when the
    source is unavailable, nothing needs rewriting, or the function's
    shape is outside the supported subset (closures, foreign decorators)
    — the reference's fallback behavior.

    Bound methods are converted through their underlying function and
    re-bound to the same instance.
    """
    if inspect.ismethod(fn):
        import types
        converted = convert_to_static(fn.__func__)
        if converted is fn.__func__:
            return fn
        return types.MethodType(converted, fn.__self__)
    if getattr(fn, "__ptt_dy2static__", False):
        return fn
    if getattr(fn, "__closure__", None):
        # recompiling would freeze cell contents at conversion time —
        # later mutations of the closed-over variables would go unseen.
        # Closure-carrying functions keep plain tracing.
        return fn
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return fn
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn
    # strip only the to_static decorator (re-decorating would recurse);
    # any OTHER decorator in the source would be silently dropped by a
    # rewrite, so its presence disables conversion instead
    kept = [d for d in fdef.decorator_list
            if not _is_to_static_decorator(d)]
    if kept:
        return fn
    fdef.decorator_list = []

    # names declared `global` anywhere in this function (not in nested
    # defs) must never be threaded through generated closures
    global_names = set()
    for node in ast.walk(fdef):
        if isinstance(node, ast.Global):
            global_names.update(node.names)

    # early-return lowering first: once returns inside if chains become
    # assignments to one value name, the rewriter below can thread those
    # ifs through torch.cond like any other branch assignment
    # Guard-style returns (body returns immediately) duplicate nothing;
    # deep returns in BOTH arms double the tail per nesting level, so
    # cap the ESTIMATED EMITTED VOLUME (not the flat count of returning
    # ifs — 8 shallow guards are fine, 8 nested both-arm returns would
    # be ~256x tail copies) before falling back to unconverted (python)
    # semantics for the whole function.
    lowered_returns = False
    if _return_in_ifs(fdef.body) and \
            _lowered_volume(fdef.body, 512) <= 512:
        fdef.body = _lower_returns(fdef.body, "__ptt_retval")
        lowered_returns = True

    rewriter = _Rewriter(global_names)
    new_tree = rewriter.visit(tree)
    if rewriter.converted == 0 and not lowered_returns:
        return fn  # nothing converted — keep the original object
    ast.fix_missing_locations(new_tree)

    # execute against the REAL module globals so `global` writes land in
    # the module and later global rebindings stay visible; only the
    # handful of __ptt_* helpers are added (underscore-prefixed, stable)
    glb: Dict[str, Any] = fn.__globals__
    glb.setdefault("__ptt_convert_ifelse", convert_ifelse)
    glb.setdefault("__ptt_convert_while", convert_while_loop)
    glb.setdefault("__ptt_UNDEFINED", UNDEFINED)
    glb.setdefault("__ptt_not_any", convert_not_any)
    glb.setdefault("__ptt_and_not", convert_and_not)
    glb.setdefault("__ptt_flag_off", convert_flag_off)
    glb.setdefault("__ptt_assert", convert_assert)
    loc: Dict[str, Any] = {}
    code = compile(new_tree, filename=f"<dy2static {fn.__qualname__}>",
                   mode="exec")
    exec(code, glb, loc)
    out = loc[fdef.name]
    out = functools.wraps(fn)(out)
    out.__ptt_dy2static__ = True
    if _CODE_LEVEL[0] > 0 or _VERBOSITY[0] >= 3:
        print(f"--- dy2static transformed code of "
              f"{fn.__qualname__} ---")
        print(ast.unparse(new_tree))
    return out
