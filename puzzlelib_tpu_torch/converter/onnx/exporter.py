"""ONNX model export (counterpart of ``puzzlelib_tpu/converter/onnx/exporter.py``).

Walks the container tree and emits ONNX nodes; serialization uses the
self-contained wire-format writer in ``onnxmodel`` (no onnx runtime is
needed).  The weights leave the device through ``gpuarray.get``, so a bf16
net's initializers are the f32 values of its bf16 weights, exactly.
"""

import os

import numpy as np

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.containers.container import Container
from puzzlelib_tpu_torch.containers.sequential import Sequential
from puzzlelib_tpu_torch.containers.parallel import Parallel
from puzzlelib_tpu_torch.containers.graph import Graph

from puzzlelib_tpu_torch.modules import (
    Add, Concat, Conv2D, BatchNorm, BatchNorm2D, Activation, relu, leakyRelu, sigmoid, tanh,
    Identity, Dropout, MaxPool2D, AvgPool2D, Flatten, Linear, SoftMax, Replicate, MulAddConst,
    Split, Upsample2D
)

from puzzlelib_tpu_torch.converter.onnx import onnxmodel as onnx


class ONNXExporter:
    def __init__(self, validate=True, exportWeights=True):
        self.validate = validate
        self.exportWeights = exportWeights

        self.nodes = []
        self.initializer = []

    def export(self, net, inshape, savepath):
        outshape = net.dataShapeFrom(inshape)

        inshape = [inshape] if not isinstance(inshape, list) else inshape
        outshape = [outshape] if not isinstance(outshape, list) else outshape

        inputs = ["data_%s" % i for i in range(len(inshape))]
        outputs = self.convertModule(net, net.name, inputs)

        inputs = [
            onnx.makeTensorValueInfo(name, onnx.FLOAT, inshape[i])
            for i, name in enumerate(inputs)
        ]
        inputs.extend(
            onnx.makeTensorValueInfo(init.name, init.data_type, init.dims) for init in self.initializer
        )

        outputs = [
            onnx.makeTensorValueInfo(name, onnx.FLOAT, outshape[i])
            for i, name in enumerate(outputs)
        ]

        graph = onnx.makeGraph(self.nodes, net.name or "net", inputs, outputs,
                               initializer=self.initializer if self.exportWeights else [])
        model = onnx.makeModel(graph, producerName="puzzlelib_tpu_torch")

        data = model.serialize()
        with open(os.path.join(savepath, "%s.onnx" % net.name), "wb") as f:
            f.write(data)

        if self.validate:
            onnx.parseModel(data)  # wire-format round-trip check

        return model

    def convertModule(self, module, fullname, inputs):
        if isinstance(module, Container):
            if isinstance(module, Sequential):
                return self.convertSequential(module, fullname, inputs)
            elif isinstance(module, Parallel):
                return self.convertParallel(module, fullname, inputs)
            elif isinstance(module, Graph):
                return self.convertGraph(module, fullname, inputs)
            else:
                raise NotImplementedError(module.__class__.__name__)

        if isinstance(module, Add):
            return self.convertAdd(fullname, inputs)

        if isinstance(module, Concat):
            return self.convertConcat(module, fullname, inputs)

        if isinstance(module, Replicate):
            return self.convertReplicate(module, inputs[0] if len(inputs) == 1 else inputs)

        assert len(inputs) == 1
        inp = inputs[0]

        if isinstance(module, Conv2D):
            return self.convertConv(module, fullname, inp)
        elif isinstance(module, (BatchNorm, BatchNorm2D)):
            return self.convertBatchNorm(module, fullname, inp)
        elif isinstance(module, Activation):
            return self.convertActivation(module, fullname, inp)
        elif isinstance(module, (Identity, Dropout)):
            return self.convertIdentity(inp)
        elif isinstance(module, (MaxPool2D, AvgPool2D)):
            return self.convertPool(module, fullname, inp)
        elif isinstance(module, Flatten):
            return self.convertFlatten(fullname, inp)
        elif isinstance(module, Linear):
            return self.convertLinear(module, fullname, inp)
        elif isinstance(module, SoftMax):
            return self.convertSoftmax(fullname, inp)
        elif isinstance(module, MulAddConst):
            return self.convertMulAddConst(module, fullname, inp)
        elif isinstance(module, Split):
            return self.convertSplit(module, fullname, [inp])
        elif isinstance(module, Upsample2D):
            return self.convertUpsample2D(module, fullname, inp)
        else:
            raise NotImplementedError(module.__class__.__name__)

    def convertSequential(self, seq, fullname, inputs):
        for child in seq.graph:
            name = "%s.%s" % (fullname, child.name)
            inputs = self.convertModule(child, name, inputs)

        return inputs

    def convertParallel(self, parallel, fullname, inputs):
        assert len(inputs) == len(parallel.graph)

        outputs = []
        for i, child in enumerate(parallel.graph):
            name = "%s.%s" % (fullname, child.name)
            outputs.append(self.convertModule(child, name, [inputs[i]])[0])

        return outputs

    def convertNode(self, node, fullname, inputs, nodes):
        name = None if node.name is None else "%s.%s" % (fullname, node.name)
        nodeInputs = [inputs[node.name]] if len(node.bwds) == 0 else \
            [nodes[output.name] for output, _ in node.bwds]

        outputs = self.convertModule(node.module, name, nodeInputs)
        assert len(outputs) == 1

        nodes[node.name] = outputs[0]

    def convertGraph(self, graph, fullname, inputs):
        assert len(inputs) == len(graph.inputs)

        nodes = {}
        inputs = {node.name: inputs[i] for i, node in enumerate(graph.inputs)}

        for inp in graph.inputs:
            inp.traverseForward(inp, self.convertNode, fullname, inputs, nodes)

        graph.reset()
        return [nodes[output.name] for output in graph.outputs]

    def _addInit(self, name, tensor, dims=None):
        tensor = np.asarray(tensor)
        self.initializer.append(onnx.makeTensor(
            name=name, dataType=onnx.FLOAT, dims=tensor.shape if dims is None else dims,
            vals=tensor.reshape(-1)
        ))

    def convertAdd(self, fullname, inputs):
        assert len(inputs) == 2

        self.nodes.append(onnx.makeNode("Add", inputs=inputs, outputs=[fullname]))
        return [fullname]

    def convertConcat(self, module, fullname, inp):
        self.nodes.append(onnx.makeNode("Concat", inputs=inp, outputs=[fullname], axis=module.axis))
        return [fullname]

    def convertConv(self, module, fullname, inp):
        assert module.dilation == (1, 1) and module.groups == 1

        wpad, hpad = module.pad
        pads = [wpad, hpad, wpad, hpad]

        Wname = "%s.W" % fullname
        self._addInit(Wname, gpuarray.get(module.W))

        inputs = [inp, Wname]

        if module.useBias:
            biasname = "%s.b" % fullname
            bias = gpuarray.get(module.b)
            self._addInit(biasname, bias.flatten(), dims=(bias.shape[1], ))
            inputs.append(biasname)

        self.nodes.append(onnx.makeNode(
            "Conv", inputs=inputs, outputs=[fullname], pads=pads, strides=list(module.stride)
        ))
        return [fullname]

    def convertBatchNorm(self, module, fullname, inp):
        names = ["%s.%s" % (fullname, suffix) for suffix in ("scale", "bias", "mean", "var")]
        tensors = [gpuarray.get(t) for t in (module.scale, module.bias, module.mean, module.var)]

        for name, tensor in zip(names, tensors):
            self._addInit(name, tensor.flatten())

        self.nodes.append(onnx.makeNode(
            "BatchNormalization", inputs=[inp] + names, outputs=[fullname], epsilon=float(module.epsilon)
        ))
        return [fullname]

    def convertActivation(self, module, fullname, inp):
        actType = module.activation

        opmap = {relu: ("Relu", {}), sigmoid: ("Sigmoid", {}), tanh: ("Tanh", {})}

        if actType in opmap:
            typ, attrs = opmap[actType]
        elif actType == leakyRelu:
            typ, attrs = "LeakyRelu", {"alpha": float(module.actArgs[0])}
        else:
            raise NotImplementedError(actType)

        self.nodes.append(onnx.makeNode(typ, inputs=[inp], outputs=[fullname], **attrs))
        return [fullname]

    @classmethod
    def convertIdentity(cls, inp):
        return [inp]

    def convertPool(self, module, fullname, inp):
        typ = {MaxPool2D: "MaxPool", AvgPool2D: "AveragePool"}[type(module)]

        wpad, hpad = module.pad
        pads = [wpad, hpad, wpad, hpad]

        self.nodes.append(onnx.makeNode(
            typ, inputs=[inp], outputs=[fullname],
            kernel_shape=list(module.size), pads=pads, strides=list(module.stride)
        ))
        return [fullname]

    def convertFlatten(self, fullname, inp):
        self.nodes.append(onnx.makeNode("Flatten", inputs=[inp], outputs=[fullname], axis=1))
        return [fullname]

    def convertLinear(self, module, fullname, inp):
        Wname = "%s.W" % fullname
        self._addInit(Wname, gpuarray.get(module.W))

        mulname = "%s.mul" % fullname
        self.nodes.append(onnx.makeNode("MatMul", inputs=[inp, Wname], outputs=[mulname]))

        if module.useBias:
            biasname = "%s.b" % fullname
            self._addInit(biasname, gpuarray.get(module.b))

            self.nodes.append(onnx.makeNode("Add", inputs=[mulname, biasname], outputs=[fullname]))
        else:
            fullname = mulname

        return [fullname]

    def convertSoftmax(self, fullname, inp):
        self.nodes.append(onnx.makeNode("Softmax", inputs=[inp], outputs=[fullname], axis=1))
        return [fullname]

    @classmethod
    def convertReplicate(cls, module, inp):
        return [inp] * module.times

    def convertMulAddConst(self, module, fullname, inp):
        aname, bname = "%s.a" % fullname, "%s.b" % fullname

        self._addInit(aname, np.array([module.a], dtype=np.float32))
        self._addInit(bname, np.array([module.b], dtype=np.float32))

        mulname = "%s.mul" % fullname
        self.nodes.append(onnx.makeNode("Mul", inputs=[inp, aname], outputs=[mulname]))
        self.nodes.append(onnx.makeNode("Add", inputs=[mulname, bname], outputs=[fullname]))

        return [fullname]

    def convertSplit(self, module, fullname, inp):
        outputs = ["%s_%s" % (fullname, i) for i in range(len(module.sections))]

        self.nodes.append(onnx.makeNode(
            "Split", inputs=inp, outputs=outputs, axis=module.axis, split=list(module.sections)
        ))
        return outputs

    def convertUpsample2D(self, module, fullname, inp):
        assert module.mode == "nearest"

        roiname = "%s.roi" % fullname
        self._addInit(roiname, np.array([], dtype=np.float32))

        scalename = "%s.scales" % fullname
        self._addInit(scalename, np.array([1.0, 1.0, module.scale, module.scale], dtype=np.float32))

        self.nodes.append(onnx.makeNode(
            "Resize", inputs=[inp, roiname, scalename], outputs=[fullname], mode=b"nearest"
        ))
        return [fullname]
