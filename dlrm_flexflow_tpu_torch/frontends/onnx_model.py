"""ONNX frontend: onnx graph -> FFModel ops (counterpart of
``dlrm_flexflow_tpu/frontends/onnx_model.py``, the same handlers and
messages).

The reference ONNX importer (reference: python/flexflow/onnx/model.py:23+ — per-node handle* methods
for Add, AveragePool, BatchNormalization, Conv, Concat, Dropout, Flatten,
Gemm/Dense, MaxPool, Relu, Reshape, Softmax, Split).

The ``onnx`` package is optional; importing this module is safe without
it, and ``ONNXModel`` raises the JAX package's ``ImportError`` if the
package is missing.  The handlers and ``lower_onto`` read a node's
``input``, ``output``, ``op_type`` and ``attribute`` fields only, so a
graph whose nodes need no initializer lowers without the package.
"""

from __future__ import annotations

from typing import Dict, Optional


from ..config import FFConfig
from ..model import FFModel


class ONNXModel:
    """reference onnx/model.py:23 ONNXModel(filename).apply(ffmodel, dims)."""

    def __init__(self, filename_or_model):
        try:
            import onnx
        except ImportError as e:  # pragma: no cover - env without onnx
            raise ImportError(
                "the 'onnx' package is required for the ONNX frontend; "
                "it is not bundled in this environment") from e
        if isinstance(filename_or_model, str):
            self.model = onnx.load(filename_or_model)
        else:
            self.model = filename_or_model
        self.symbol_table: Dict[str, object] = {}
        self.initializers = {i.name: i for i in self.model.graph.initializer}

    # ---------------------------------------------------------------- helpers
    @staticmethod
    def _attrs(node):
        return {a.name: a for a in node.attribute}

    def _init_array(self, name):
        import onnx.numpy_helper as nh

        return nh.to_array(self.initializers[name])

    # ---------------------------------------------------------------- handles
    def handleAdd(self, ff, node):
        a = self.symbol_table[node.input[0]]
        b = self.symbol_table[node.input[1]]
        self.symbol_table[node.output[0]] = ff.add(a, b)

    def handleSub(self, ff, node):
        a = self.symbol_table[node.input[0]]
        b = self.symbol_table[node.input[1]]
        self.symbol_table[node.output[0]] = ff.subtract(a, b)

    def handleMul(self, ff, node):
        a = self.symbol_table[node.input[0]]
        b = self.symbol_table[node.input[1]]
        self.symbol_table[node.output[0]] = ff.multiply(a, b)

    def handleConcat(self, ff, node):
        attrs = self._attrs(node)
        tensors = [self.symbol_table[i] for i in node.input]
        self.symbol_table[node.output[0]] = ff.concat(tensors,
                                                      attrs["axis"].i)

    def handleSplit(self, ff, node):
        attrs = self._attrs(node)
        x = self.symbol_table[node.input[0]]
        sizes = list(attrs["split"].ints)
        outs = ff.split(x, sizes, attrs["axis"].i)
        for o, name in zip(outs, node.output):
            self.symbol_table[name] = o

    def handleAveragePool(self, ff, node):
        attrs = self._attrs(node)
        x = self.symbol_table[node.input[0]]
        k = attrs["kernel_shape"].ints
        p = attrs["pads"].ints if "pads" in attrs else [0, 0]
        s = attrs["strides"].ints
        self.symbol_table[node.output[0]] = ff.pool2d(
            x, k[0], k[1], s[0], s[1], p[0], p[1], pool_type="avg")

    def handleMaxPool(self, ff, node):
        attrs = self._attrs(node)
        x = self.symbol_table[node.input[0]]
        k = attrs["kernel_shape"].ints
        p = attrs["pads"].ints if "pads" in attrs else [0, 0]
        s = attrs["strides"].ints
        self.symbol_table[node.output[0]] = ff.pool2d(
            x, k[0], k[1], s[0], s[1], p[0], p[1], pool_type="max")

    def handleBatchNormalization(self, ff, node):
        x = self.symbol_table[node.input[0]]
        self.symbol_table[node.output[0]] = ff.batch_norm(x)

    def handleConv(self, ff, node):
        attrs = self._attrs(node)
        x = self.symbol_table[node.input[0]]
        w = self._init_array(node.input[1])  # OIHW
        out_channels = w.shape[0]
        k = attrs["kernel_shape"].ints
        p = attrs["pads"].ints if "pads" in attrs else [0, 0]
        s = attrs["strides"].ints if "strides" in attrs else [1, 1]
        groups = attrs["group"].i if "group" in attrs else 1
        self.symbol_table[node.output[0]] = ff.conv2d(
            x, out_channels, k[0], k[1], s[0], s[1], p[0], p[1],
            use_bias=len(node.input) > 2, groups=groups)

    def handleGemm(self, ff, node):
        x = self.symbol_table[node.input[0]]
        w = self._init_array(node.input[1])
        out_dim = w.shape[0]
        self.symbol_table[node.output[0]] = ff.dense(
            x, out_dim, use_bias=len(node.input) > 2)

    handleDense = handleGemm

    def handleMatMul(self, ff, node):
        x = self.symbol_table[node.input[0]]
        w = self._init_array(node.input[1])
        self.symbol_table[node.output[0]] = ff.dense(x, w.shape[1],
                                                     use_bias=False)

    def handleDropout(self, ff, node):
        attrs = self._attrs(node)
        x = self.symbol_table[node.input[0]]
        rate = attrs["ratio"].f if "ratio" in attrs else 0.5
        self.symbol_table[node.output[0]] = ff.dropout(x, rate)

    def handleFlatten(self, ff, node):
        x = self.symbol_table[node.input[0]]
        self.symbol_table[node.output[0]] = ff.flat(x)

    def handleRelu(self, ff, node):
        x = self.symbol_table[node.input[0]]
        self.symbol_table[node.output[0]] = ff.relu(x)

    def handleSigmoid(self, ff, node):
        x = self.symbol_table[node.input[0]]
        self.symbol_table[node.output[0]] = ff.sigmoid(x)

    def handleTanh(self, ff, node):
        x = self.symbol_table[node.input[0]]
        self.symbol_table[node.output[0]] = ff.tanh(x)

    def handleSoftmax(self, ff, node):
        x = self.symbol_table[node.input[0]]
        self.symbol_table[node.output[0]] = ff.softmax(x)

    def handleReshape(self, ff, node):
        x = self.symbol_table[node.input[0]]
        shape = self._init_array(node.input[1]).tolist()
        b = x.shape[0]
        if shape and shape[0] in (-1, 0):
            shape[0] = b
        self.symbol_table[node.output[0]] = ff.reshape(x, shape)

    # ------------------------------------------------------------------ apply
    def apply(self, ffconfig: FFConfig,
              input_shapes: Optional[Dict[str, tuple]] = None) -> FFModel:
        """Build an FFModel from the onnx graph.  ``input_shapes`` overrides
        per-sample shapes; otherwise they come from the graph's value_info
        (with the first dim treated as batch)."""
        ff = FFModel(ffconfig)
        b = ffconfig.batch_size
        for inp in self.model.graph.input:
            if inp.name in self.initializers:
                continue
            if input_shapes and inp.name in input_shapes:
                shape = tuple(input_shapes[inp.name])
            else:
                dims = inp.type.tensor_type.shape.dim
                shape = tuple(int(d.dim_value) for d in list(dims)[1:])
            self.symbol_table[inp.name] = ff.create_tensor(
                (b,) + shape, name=inp.name)
        self.lower_onto(ff, self.symbol_table)
        return ff

    def lower_onto(self, ff, bound_inputs):
        """Replay the onnx graph onto an existing model with graph inputs
        pre-bound to core tensors (the reference ONNXModel.apply(ffmodel,
        {name: tensor}) contract, onnx/model.py:23+).  Returns the graph
        output tensors."""
        self.symbol_table = dict(bound_inputs)
        for node in self.model.graph.node:
            handler = getattr(self, "handle" + node.op_type, None)
            if handler is None:
                raise NotImplementedError(f"onnx op {node.op_type}")
            handler(ff, node)
        outs = []
        for o in self.model.graph.output:
            if o.name in self.symbol_table:
                outs.append(self.symbol_table[o.name])
        if not outs:  # graphs without declared outputs: last value wins
            outs = [next(reversed(self.symbol_table.values()))]
        return outs
