"""Layer, the module base class (the port of
``paddle_tpu/nn/layer/layers.py``).

Parameter / buffer / sublayer registries routed through ``__setattr__``,
``state_dict`` with dotted structured names, train / eval recursion,
forward pre and post hooks, ``create_parameter`` through ``ParamAttr``
and an initializer.  A ``Parameter`` holds a leaf torch tensor on the
current place; value updates (the optimizer, ``set_state_dict``) write
into its storage, so it stays the same leaf from step to step.
``raw_dict()`` / ``load_raw_dict()`` hand out and take the torch
tensors, and ``functional_forward`` runs ``forward`` over substituted
ones.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator, List

import torch

from ...core.tensor import Tensor, _as_torch, _unwrap
from ...core.place import _parse_device
from ...core import dtype as dtype_mod
from ...framework.param_attr import ParamAttr
from ..initializer import _resolve_initializer

__all__ = ["Layer", "Parameter", "Sequential", "LayerList", "ParameterList",
           "LayerDict"]


class Parameter(Tensor):
    """A trainable leaf tensor (paddle's EagerParamBase)."""

    def __init__(self, array, trainable=True, name=""):
        t = _unwrap(array)
        if not torch.is_tensor(t):
            t = _as_torch(t, None, None)
        super().__init__(t.detach(), stop_gradient=not trainable, name=name)
        self.is_leaf_param = True
        self.persistable = True
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True

    def _set_array(self, new):
        """Write ``new`` into the parameter's own storage (cast to its
        dtype), so it stays the same leaf; a new shape or device
        rebinds it."""
        new = _unwrap(new)
        t = self._t
        if new is t:
            return self
        if new.shape == t.shape and new.device == t.device:
            with torch.no_grad():
                t.copy_(new)
            return self
        return super()._set_array(new.detach())

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()

_name_counters: Dict[str, int] = collections.defaultdict(int)


def _unique_name(prefix):
    _name_counters[prefix] += 1
    return f"{prefix}_{_name_counters[prefix] - 1}"


class HookRemoveHelper:
    def __init__(self, hooks, hook_id):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = dtype_mod.convert_dtype(dtype)
        self._parameters: Dict[str, Parameter] = collections.OrderedDict()
        self._sub_layers: Dict[str, "Layer"] = collections.OrderedDict()
        self._buffers: Dict[str, Tensor] = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._hook_id = 0
        self._full_name = _unique_name(
            name_scope or type(self).__name__.lower())

    # -- naming -----------------------------------------------------------
    def full_name(self):
        return self._full_name

    # -- parameter creation ----------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        dt = dtype_mod.convert_dtype(dtype) or self._dtype
        init = _resolve_initializer(attr, default_initializer, is_bias)
        arr = init([int(s) for s in shape], dt)
        p = Parameter(arr, trainable=attr.trainable)
        p.name = attr.name or _unique_name("param")
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def create_tensor(self, name=None, persistable=None, dtype=None):
        from ...core.place import current_device
        return Tensor._wrap(torch.zeros(
            [0], dtype=dtype_mod.convert_dtype(dtype) or self._dtype,
            device=current_device()))

    # -- attribute routing -------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ first")
            params[name] = value
            for d in (layers, buffers):
                if d is not None:
                    d.pop(name, None)
            object.__setattr__(self, name, value)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ first")
            layers[name] = value
            for d in (params, buffers):
                if d is not None:
                    d.pop(name, None)
            object.__setattr__(self, name, value)
        else:
            if params is not None and name in params and value is None:
                del params[name]
            if layers is not None and name in layers and value is None:
                del layers[name]
            if buffers is not None and name in buffers \
                    and isinstance(value, (Tensor, type(None))):
                buffers[name] = value
            object.__setattr__(self, name, value)

    def add_sublayer(self, name, sublayer):
        if sublayer is not None:
            self._sub_layers[str(name)] = sublayer
            object.__setattr__(self, str(name), sublayer)
        return sublayer

    def add_parameter(self, name, parameter):
        if parameter is not None:
            self._parameters[str(name)] = parameter
            object.__setattr__(self, str(name), parameter)
        return parameter

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[str(name)] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(str(name))
        object.__setattr__(self, str(name), tensor)
        return tensor

    # -- traversal ---------------------------------------------------------
    def children(self) -> Iterator["Layer"]:
        for _, l in self.named_children():
            yield l

    def named_children(self):
        seen = set()
        for name, l in self._sub_layers.items():
            if l is not None and id(l) not in seen:
                seen.add(id(l))
                yield name, l

    def sublayers(self, include_self=False) -> List["Layer"]:
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        if layers_set is None:
            layers_set = set()
        if id(self) in layers_set:
            return
        layers_set.add(id(self))
        if include_self:
            yield prefix, self
        for name, l in self.named_children():
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield from l.named_sublayers(prefix=sub_prefix, include_self=True,
                                         layers_set=layers_set)

    def parameters(self, include_sublayers=True) -> List[Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        layers = self.named_sublayers(prefix=prefix, include_self=True) \
            if include_sublayers else [(prefix, self)]
        for lp, layer in layers:
            for name, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (f"{lp}.{name}" if lp else name), p

    def functional_forward(self, param_arrays, *input_arrays, **kwargs):
        """Run forward() with the parameters substituted by
        ``param_arrays`` (torch tensors, in ``self.parameters()``'s
        order) on torch tensor inputs, returning torch tensors.  Autograd
        sees through it: gradients flow to ``param_arrays``."""
        params = self.parameters()
        if len(param_arrays) != len(params):
            raise ValueError(
                f"expected {len(params)} param arrays, got "
                f"{len(param_arrays)}")
        old = [p._t for p in params]
        try:
            for p, a in zip(params, param_arrays):
                p._t = a
            out = self.forward(*[Tensor._wrap(a) for a in input_arrays],
                               **kwargs)
            if isinstance(out, (tuple, list)):
                return type(out)(o._t if isinstance(o, Tensor) else o
                                 for o in out)
            return out._t if isinstance(out, Tensor) else out
        finally:
            for p, o in zip(params, old):
                p._t = o

    def buffers(self, include_sublayers=True) -> List[Tensor]:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        layers = self.named_sublayers(prefix=prefix, include_self=True) \
            if include_sublayers else [(prefix, self)]
        for lp, layer in layers:
            for name, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (f"{lp}.{name}" if lp else name), b

    # -- mode --------------------------------------------------------------
    def train(self):
        self.training = True
        for l in self.sublayers():
            l.training = True
        return self

    def eval(self):
        self.training = False
        for l in self.sublayers():
            l.training = False
        return self

    def apply(self, fn):
        for l in self.sublayers(include_self=True):
            fn(l)
        return self

    def to(self, device=None, dtype=None, blocking=None):
        """Move the parameters and buffers to ``device`` and / or cast
        the floating ones to ``dtype`` (their gradients are dropped)."""
        dev = _parse_device(device).device if device is not None else None
        dt = dtype_mod.convert_dtype(dtype)
        for t in self.parameters() + self.buffers():
            if t is None:
                continue
            cast = dt if dt is not None and dtype_mod.is_floating_point(
                t.dtype) else None
            if dev is None and cast is None:
                continue
            req = t._t.requires_grad
            new = t._t.detach().to(device=dev, dtype=cast)
            t._t = new.requires_grad_(True) if req else new
        if dt is not None:
            for l in self.sublayers(include_self=True):
                l._dtype = dt
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def half(self):
        return self.to(dtype="float16")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # -- hooks -------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # -- call --------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            res = hook(self, inputs)
            if res is not None:
                inputs = res if isinstance(res, tuple) else (res,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            res = hook(self, inputs, outputs)
            if res is not None:
                outputs = res
        return outputs

    # -- state dict --------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None \
            else collections.OrderedDict()
        for name, p in self.named_parameters(prefix=structured_name_prefix,
                                             include_sublayers=include_sublayers):
            dest[name] = p
        for name, b in self.named_buffers(prefix=structured_name_prefix,
                                          include_sublayers=include_sublayers):
            short = name.rsplit(".", 1)[-1]
            # find owning layer to check persistability
            dest[name] = b
        # drop non-persistable buffers
        for lp, layer in self.named_sublayers(include_self=True):
            for bname in layer._non_persistable_buffer_names:
                key = f"{lp}.{bname}" if lp else bname
                if structured_name_prefix:
                    key = f"{structured_name_prefix}{key}"
                dest.pop(key, None)
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict()
        missing, unexpected = [], []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            target = own[k]
            arr = _as_torch(_unwrap(v), target.dtype, target._t.device)
            if tuple(arr.shape) != tuple(target._t.shape):
                raise ValueError(
                    f"shape mismatch for {k}: {tuple(arr.shape)} vs "
                    f"{tuple(target._t.shape)}")
            if not isinstance(target, Parameter):
                arr = arr.clone() if arr is _unwrap(v) else arr
            target._set_array(arr)
        for k in own:
            if k not in state_dict:
                missing.append(k)
        return missing, unexpected

    load_dict = set_state_dict

    # -- functional bridge -----------------------------------------------
    def raw_dict(self):
        """state_dict as a flat {name: torch tensor} dict."""
        return {k: v._t for k, v in self.state_dict().items()}

    def load_raw_dict(self, raw):
        sd = self.state_dict()
        for k, arr in raw.items():
            if k in sd:
                sd[k]._set_array(arr)

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, l in self.named_children():
            mod_str = repr(l)
            mod_str = "\n  ".join(mod_str.split("\n"))
            lines.append(f"({name}): {mod_str}")
        main = type(self).__name__ + "(" + extra
        if lines:
            main += "\n  " + "\n  ".join(lines) + "\n"
        return main + ")"

    def extra_repr(self):
        return ""


class Sequential(Layer):
    """Reference: python/paddle/nn/layer/container.py Sequential."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, item in enumerate(layers):
                if isinstance(item, tuple):
                    self.add_sublayer(item[0], item[1])
                else:
                    self.add_sublayer(str(i), item)

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, l in enumerate(sublayers):
                self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self.__class__(list(self._sub_layers.values())[idx])
        return self._sub_layers[str(idx if idx >= 0 else
                                    len(self) + idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._sub_layers.values())
        layers.insert(index, layer)
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l
        return self

    def extend(self, layers):
        for l in layers:
            self.append(l)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def keys(self):
        return self._sub_layers.keys()

    def values(self):
        return self._sub_layers.values()

    def items(self):
        return self._sub_layers.items()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) else sublayers
        for k, v in items:
            self.add_sublayer(k, v)
        return self
